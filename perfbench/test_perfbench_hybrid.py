"""CPU tests of the hybrid prefill cell (``nemotron3-nano-30b-a3b.prefill-s16k``,
mix kind ``prefill_hybrid``) and of the dense 8k prefill cell
(``qwen3-1.7b.prefill-s8k``): their files, the frozen FLOP and byte counts
against hand-worked figures, the hybrid weights laid out as the port's, a
traced run that records the program's Mamba-2 and MoE spans, and the check:
a sound run at a reduced size is correct, and the float8 control, an
altered answer and a replay that differs are not."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import flops, flops_hybrid, harness, spans, spec

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HYBRID = "nemotron3-nano-30b-a3b.prefill-s16k"
DENSE = "qwen3-1.7b.prefill-s8k"
PATTERN = "MEM*EME"
KINDS = {"M": ("mamba", "none"), "E": ("none", "moe"), "*": ("attn", "none")}
SMALL = dict(n_layers=len(PATTERN), d_model=64, vocab_size=512, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
             moe_d_ff=32, moe_shared_d_ff=48, n_experts=4, top_k=2, ssm_state=16, ssm_head_dim=16, ssm_heads=4,
             ssm_groups=2, block_kinds=[KINDS[c][0] for c in PATTERN], mlp_kinds=[KINDS[c][1] for c in PATTERN])
MIX = dict(prompt_len=64, ssd_chunk=16, check_requests=4, trace_seconds=0.2)
NEW_SPANS = {"mamba/proj", "mamba/ssd", "moe/dispatch", "moe/experts", "moe/combine", "moe/shared"}
HYBRID_METRICS = {"prefill_mfu.hybrid", "ssd_roofline.prefill_hybrid", "mamba_ssd_ms.prefill_hybrid",
                  "mamba_proj_ms.prefill_hybrid", "moe_routed_ms.prefill_hybrid", "moe_shared_ms.prefill_hybrid",
                  "moe_row_use.prefill_hybrid", "device_idle.prefill_hybrid"}
SEED = 2**35 + 3


def run(**kw):
    return harness.run_cell(HYBRID, kw.pop("seed", SEED), 0.3, kw.pop("trace", False), device="cpu",
                            config_override=SMALL, mix_override=MIX, **kw)


def test_the_new_cells_and_their_metrics():
    cells = {w["name"]: spec.load(w["name"]) for w in BENCH["workloads"]}
    hybrid, dense = cells[HYBRID], cells[DENSE]
    assert hybrid.mix["kind"] == "prefill_hybrid" and dense.mix["kind"] == "prefill"
    assert {m["name"] for m in hybrid.end_to_end} == {"ttft_p95_ms", "setup_s"}
    assert {m["name"] for m in dense.end_to_end} == {"ttft_p95_ms", "prefill_tokens_per_s", "setup_s"}
    assert {m["name"] for m in hybrid.per_layer} == HYBRID_METRICS | {"ttft_p50_ms"}
    for name, cell in cells.items():  # the hybrid metrics go to the hybrid cell alone
        if name != HYBRID:
            assert not HYBRID_METRICS & {m["name"] for m in cell.per_layer}, name
    assert {m["name"] for m in dense.per_layer} == {"ttft_p50_ms", "attn_roofline.prefill", "prefill_mfu",
                                                   "device_idle.prefill"}
    assert set(hybrid.limits) == {"logit_err_max", "token_misses", "route_misses", "route_departs", "replay_diff"}
    assert set(dense.limits) == {"logit_err_max", "token_misses"}
    assert hybrid.config["reduced"] == {} and hybrid.config["n_layers"] == 52


def test_the_configuration_holds_the_published_keys():
    cell = spec.load(HYBRID)
    published = cell.config["published"]
    for key, value in published.items():  # each published key at the top level, unchanged
        assert cell.config[key] == value, key
    cfg = cell.model_config()
    pattern = published["hybrid_override_pattern"]
    assert cfg.n_layers == published["num_hidden_layers"] == len(pattern)
    assert [cfg.block_kinds[i] == "mamba" for i in range(52)] == [c == "M" for c in pattern]
    assert [cfg.mlp_kinds[i] == "moe" for i in range(52)] == [c == "E" for c in pattern]
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state) == (
        published["mamba_num_heads"], published["mamba_head_dim"], published["n_groups"], published["ssm_state_size"])
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff, cfg.moe_shared_d_ff, cfg.moe_routed_scale) == (
        published["n_routed_experts"], published["num_experts_per_tok"], published["moe_intermediate_size"],
        published["moe_shared_expert_intermediate_size"], published["routed_scaling_factor"])
    assert cell.mix["ssd_chunk"] == published["chunk_size"] and cfg.mlp_kind == "relu2"


def test_hybrid_flop_counts_match_the_hand_worked_figures():
    cfg = spec.load(HYBRID).model_config()
    d, v = 2688, 131072
    mamba = d + d * (4096 + 6144 + 64) + 5 * 6144 + 3 * 64 + 4096 + 4096 * d  # in_proj, conv w + b, A D dt, norm, out
    moe = d + d * 128 + 128 + 6 * 2 * d * 1856 + 2 * d * 3712
    attn = d + 2 * d * 32 * 128 + 2 * d * 2 * 128
    pc = flops_hybrid.param_counts(cfg)
    assert pc == {"active": 23 * mamba + 23 * moe + 6 * attn + d + 2 * v * d, "embed": 2 * v * d}
    assert pc["active"] == 3_580_076_352
    # one SSD call at the cell's shape: 128 chunks of 128 tokens, 8,256 causal pairs a chunk
    ops, nbytes = flops_hybrid.ssd_cost(1, 16384, 64, 64, 128, 8, 128)
    assert ops == 128 * (8 * 8256 * 256 + 64 * 8256 * 128 + 64 * 4 * 128 * 64 * 128) == 45_181_042_688
    assert nbytes == 2 * 16384 * 64 * 64 * 2 + 4 * 16384 * 64 + 2 * 16384 * 8 * 128 * 2 + 4 * 64 * 64 * 128
    body = 2 * (pc["active"] - pc["embed"]) * 16384
    attn_ops = 4 * 16384 * 16384 * 32 * 128 * 6 / 2
    assert flops_hybrid.prefill_request_flops(cfg, 1, 16384) == body + attn_ops + 23 * ops + 2 * d * v
    assert flops_hybrid.prefill_request_flops(cfg, 1, 16384) == pytest.approx(1.0846e14, rel=1e-4)
    t, by = flops.roofline_s(ops, nbytes)
    assert by == "bytes" and t == pytest.approx(nbytes / flops.PEAK_HBM_BYTES_S)
    dense = spec.load(DENSE).model_config()
    assert flops.prefill_request_flops(dense, 1, 8192) == pytest.approx(3.079e13, rel=1e-3)


def test_hybrid_weights_are_seeded_and_laid_out_as_the_port():
    from repro_torch.models.model import Model, init_params

    cell = spec.load(HYBRID)
    cell.config.update(SMALL)
    cfg, drv = cell.model_config(), cell.driver()
    a = drv.make(cfg, 2**40 + 3, torch.bfloat16, "cpu", cell.config["init"])
    b = drv.make(cfg, 2**40 + 3, torch.bfloat16, "cpu", cell.config["init"])
    mine = dict(Model(a).named_parameters())
    port = dict(init_params(cfg, 0, dtype=torch.bfloat16, device="cpu").named_parameters())
    assert sorted(mine) == sorted(port)
    for n, p in port.items():
        assert mine[n].shape == p.shape and mine[n].dtype == p.dtype, n
    assert all(torch.equal(x, y) for x, y in zip(Model(a).parameters(), Model(b).parameters()))
    m = a["layers"][0]["mixer"]
    a_neg = -torch.exp(m["a_log"].float())
    assert bool((a_neg <= -1).all() and (a_neg >= -16.1).all())
    dt = torch.nn.functional.softplus(m["dt_bias"].float())
    assert bool((dt > 5e-4).all() and (dt < 0.11).all())
    assert a["layers"][1]["mlp"]["router_bias"].dtype == torch.float32
    assert float(a["layers"][1]["mlp"]["router_bias"].std()) == pytest.approx(0.01, rel=0.5)


def test_sound_run_is_correct_and_compares_every_request():
    result = run()
    assert result["correct"], result["checks"]
    notes = result["notes"]
    assert notes["rows_sampled"] == notes["rows_compared"] == min(MIX["check_requests"], result["attempted"])
    assert len(notes["drop_share_by_layer"]) == PATTERN.count("E")
    assert result["checks"]["replay_diff"]["value"] == 0.0


def test_float8_control_fails():
    cell = spec.load(HYBRID)
    cell.config.update(SMALL)
    cell.mix.update(MIX)
    numbers = cell.driver().Driver(cell, cell.model_config(), SEED, torch.device("cpu")).control()
    assert any(numbers[n] > cell.limits[n] for n in numbers), (numbers, cell.limits)


def test_altered_answer_fails(monkeypatch):
    from repro_torch.launch import serve as port_serve

    real = port_serve.generate

    def broken(*a, **k):  # each answer shifted by one vocabulary entry, so its token too
        tokens, logits = real(*a, **k)
        return tokens, torch.roll(logits, 1, -1)

    monkeypatch.setattr(port_serve, "generate", broken)
    assert not run()["correct"]


def test_a_replay_that_differs_fails(monkeypatch):
    """The check serves each sampled prompt again: an answer that changes
    between the window and the check is caught."""
    from repro_torch.launch import serve as port_serve

    real, calls = port_serve.generate, []

    def drifting(*a, **k):
        tokens, logits = real(*a, **k)
        calls.append(1)
        return tokens, logits + 1e-3 * len(calls)

    monkeypatch.setattr(port_serve, "generate", drifting)
    result = run()
    assert not result["correct"] and result["checks"]["replay_diff"]["value"] > 0


def test_a_routing_that_departs_beyond_a_near_tie_fails(monkeypatch):
    """The program routing with 50 times the correction bias departs from
    the reference where no near-tie explains it."""
    from repro_torch.models import moe

    real = moe.route_sigmoid
    monkeypatch.setattr(moe, "route_sigmoid", lambda xf, router, bias, k, scale: real(xf, router, 50 * bias, k, scale))
    result = run()
    assert not result["correct"] and result["checks"]["route_misses"]["value"] > 0


@pytest.mark.parametrize("seed", [SEED, 2**31 + 99])
def test_a_router_that_drops_the_correction_bias_fails(monkeypatch, seed):
    """The program routing by its raw scores alone departs from the
    reference only at margins under ``NEAR`` (the bias's spread lies under
    it), so every departure is forced, ``route_misses`` stays 0 and the
    logits match as well as a sound run's; it departs at many more choices
    than rounding does, and ``route_departs`` catches it. The check runs on
    the first ``check_requests`` requests, so that no timing picks them. At
    this size (4 experts, 7 layers, the f32 reference against bf16) sound
    runs depart at 0.26-1.17 % of choices and the fault at 2.73-4.82 % on
    six seeds, so the check takes a limit of 1.8 % set between them; the
    cell's own limit is set from its readings on the card (``limits/``)."""
    from repro_torch.models import moe

    cell = spec.load(HYBRID)
    cell.config.update(SMALL)
    cell.mix.update(MIX)
    limits = dict(cell.limits, route_departs=1.8)

    def numbers():
        drv = cell.driver().Driver(cell, cell.model_config(), seed, torch.device("cpu"))
        drv.setup()
        for i in range(MIX["check_requests"]):
            drv.keep(i, *drv.serve(drv.prompt("request", i)))
        drv.release()
        return drv.check()

    sound = numbers()
    assert all(sound[n] <= limits[n] for n in sound), sound
    real = moe.route_sigmoid
    monkeypatch.setattr(moe, "route_sigmoid", lambda xf, router, bias, k, scale: real(xf, router, 0 * bias, k, scale))
    fault = numbers()
    assert fault["route_misses"] == 0 and fault["logit_err_max"] <= limits["logit_err_max"]
    assert fault["route_departs"] > limits["route_departs"]


def test_a_traced_run_records_the_new_spans(monkeypatch, capsys):
    monkeypatch.setattr(spans, "RECORD_SECONDS", 0.2)
    keep = {}
    result = run(trace=True, keep=keep)
    metrics = result["metrics"]
    recorded = keep["driver"].program_spans
    assert len(recorded["roots"]) >= spans.MIN_UNITS
    assert {r["name"] for r in recorded["roots"]} == {"serve/prefill"}
    for root in recorded["roots"]:
        assert NEW_SPANS <= set(root["spans"])
        assert root["spans"]["mamba/proj"]["n"] == 2 * PATTERN.count("M")  # two intervals a layer
        assert root["spans"]["mamba/ssd"]["n"] == PATTERN.count("M")
        assert root["spans"]["moe/shared"]["n"] == PATTERN.count("E")
    c = recorded["counters"]
    rows = 4 * 40 * PATTERN.count("E") * len(recorded["roots"])  # E · C = 4 · ceil(64 · 2 · 1.25 / 4) a layer
    assert c["moe/rows"] == rows and 0 < c["moe/kept"] <= rows
    assert metrics["moe_row_use.prefill_hybrid"]["value"] == pytest.approx(100.0 * c["moe/kept"] / rows)
    assert metrics["prefill_mfu.hybrid"]["unit"] == "%" and metrics["prefill_mfu.hybrid"]["value"] > 0
    # device times need CUDA events and the profiler's device trace; none on the CPU
    assert not {"mamba_ssd_ms.prefill_hybrid", "ssd_roofline.prefill_hybrid", "moe_shared_ms.prefill_hybrid",
                "device_idle.prefill_hybrid"} & set(metrics)
    assert "spans: mamba/ssd host_ms a unit: median " in capsys.readouterr().err


def test_the_hybrid_readers_read_nothing_elsewhere():
    import types

    cell = spec.load("qwen3-moe-4l.prefill-s4k")
    run_ = types.SimpleNamespace(cell=cell, cfg=cell.model_config(), driver=types.SimpleNamespace(),
                                 device=types.SimpleNamespace(type="cuda"), trace={"window_s": 1.0, "busy_s": 0.5,
                                                                                   "n_device_ops": 3},
                                 window=types.SimpleNamespace(attempted=3, seconds=1.0))
    hybrid = spec.load(HYBRID)
    for name in HYBRID_METRICS:
        assert hybrid.reader(name).read(run_) is None, name
