"""Nemotron 3 Nano 30B-A3B (``nemotron_h``) on the port, against the plain
reference ``perfbench/reference/nemotron_h.py`` on the CPU at a small size
in float32: the grouped SSD, the grouped Mamba-2 block, the MoE layer with
the sigmoid router, relu² experts and the shared expert, the whole stack's
prefill logits, and prefill then decode through the cache. The reference
package has no such model, so the port is held to the benchmark's plain
reference here, and ``ARCHS`` stays the reference's list.

Tolerances: port and reference both compute in f32 and differ only in the
order of their sums (the SSD chunked at another length, einsum against
matmul), so they agree to F32_TOL = 1e-4 relative; the float8 control
(the reference with its bf16 products' operands rounded to e4m3) departs by
about 0.1 and fails it.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from perfbench import spec  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_naive, ssd_reference  # noqa: E402
from repro_torch.launch.serve import extend_cache  # noqa: E402
from repro_torch.models import mamba2, moe  # noqa: E402
from repro_torch.models.model import Model, RunFlags, decode_step, forward, init_params  # noqa: E402

F32_TOL = 1e-4
PATTERN = "MEM*EME"
KINDS = {"M": ("mamba", "none"), "E": ("none", "moe"), "*": ("attn", "none")}
SMALL = dict(n_layers=len(PATTERN), d_model=64, vocab_size=512, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
             moe_d_ff=32, moe_shared_d_ff=48, n_experts=4, top_k=2, ssm_state=16, ssm_head_dim=16, ssm_heads=4,
             ssm_groups=2, block_kinds=[KINDS[c][0] for c in PATTERN], mlp_kinds=[KINDS[c][1] for c in PATTERN])
FLAGS = RunFlags(attn_impl="kernel", norm_impl="kernel", ssd_impl="kernel", ssd_chunk=16)


def small(**over):
    """(cfg, the reference module, the driver module, weights f32) at the
    small size, drawn by the benchmark's hybrid driver from one seed."""
    cell = spec.load("nemotron3-nano-30b-a3b.prefill-s16k")
    cell.config.update(SMALL, **over)
    cfg = cell.model_config()
    drv = cell.driver()
    return cfg, cell.reference(), drv, drv.make(cfg, 2**33 + 5, torch.float32, "cpu", cell.config["init"])


def tokens(cfg, b, s, seed=0):
    return torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(seed))


def rel(got, want):
    return ((got - want).norm() / (want - want.mean()).norm()).item()


def test_config_is_port_only_and_published():
    cfg = registry.get_config("nemotron3-nano-30b-a3b")
    assert cfg.name not in registry.ARCHS and cfg.name in registry.PORT_ONLY
    assert cfg.n_layers == 52 and cfg.cycle_len == 52 and cfg.d_model == 2688
    assert (cfg.block_kinds.count("mamba"), cfg.mlp_kinds.count("moe"), cfg.block_kinds.count("attn")) == (23, 23, 6)
    assert (cfg.ssm_d_inner, cfg.ssm_n_heads, cfg.ssm_groups) == (4096, 64, 8)
    pc = cfg.param_counts()
    assert pc["total"] == pytest.approx(31.58e9, rel=1e-3) and pc["active"] == pytest.approx(3.58e9, rel=1e-3)
    file_cfg = spec.load("nemotron3-nano-30b-a3b.prefill-s16k").model_config()
    assert dataclasses.asdict(file_cfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_grouped_ssd_matches_the_recurrence(g):
    """The chunked plain SSD with G groups against the token-by-token
    recurrence (each head reading its group's B and C)."""
    gen = torch.Generator().manual_seed(g)
    b, s, h, p, n = 2, 64, 8, 8, 16
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
    a = -torch.exp(torch.randn(h, generator=gen))
    bm, cm = (torch.randn(b, s, g, n, generator=gen) for _ in range(2))
    y, hf = ssd_reference(x, dt, a, bm, cm, chunk=16)
    y_ref, h_ref = ssd_naive(x, dt, a, bm, cm)
    torch.testing.assert_close(y, y_ref, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(hf, h_ref, atol=F32_TOL, rtol=F32_TOL)
    # head h reads group h // (H / G): group i's heads see only its B and C
    bm2 = bm.clone()
    bm2[:, :, -1] += 1.0
    y2, _ = ssd_reference(x, dt, a, bm2, cm, chunk=16)
    last = h - h // g
    assert torch.equal(y2[:, :, :last], y[:, :, :last]) and not torch.equal(y2[:, :, last:], y[:, :, last:])


def test_one_group_is_the_shared_layout_bitwise():
    """B and C of shape (B, S, 1, N) give the bits of the (B, S, N) call."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 4, 8, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(2, 32, 4, generator=gen))
    a = -torch.exp(torch.randn(4, generator=gen))
    bm, cm = (torch.randn(2, 32, 16, generator=gen) for _ in range(2))
    one = ssd_reference(x, dt, a, bm, cm, chunk=8)
    grouped = ssd_reference(x, dt, a, bm[:, :, None], cm[:, :, None], chunk=8)
    assert all(torch.equal(u, v) for u, v in zip(one, grouped))
    h = torch.randn(2, 4, 8, 16, generator=gen)
    step = mamba2.ssd_decode_step(h, x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
    gstep = mamba2.ssd_decode_step(h, x[:, 0], dt[:, 0], a, bm[:, 0, None], cm[:, 0, None])
    torch.testing.assert_close(gstep[0], step[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(gstep[1], step[1], atol=1e-6, rtol=1e-6)
    # the one-group decode step keeps the shared layout's formula, bit for
    # bit: the grouped formula sums y in another order and moves its bits
    dtf, xf = dt[:, 0], x[:, 0]
    h_new = h * torch.exp(dtf * a)[:, :, None, None] + torch.einsum("bh,bhp,bn->bhpn", dtf, xf, bm[:, 0])
    assert torch.equal(step[1], h_new) and torch.equal(step[0], torch.einsum("bhpn,bn->bhp", h_new, cm[:, 0]))


def test_mamba_block_matches_the_reference():
    cfg, ref, _, w = small()
    p = w["layers"][0]["mixer"]
    x = torch.randn(2, 48, cfg.d_model, generator=torch.Generator().manual_seed(1))
    got, cache = mamba2.mamba2_prefill(p, x, cfg, lambda *a: ssd_reference(*a, chunk=16))
    want = ref.mamba_mixer(x, p, cfg, False)
    assert rel(got, want) < F32_TOL
    assert cache["ssm"].shape == (2, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state)
    assert cache["conv"].shape == (2, cfg.ssm_conv_width - 1, cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_layer_matches_the_reference(capacity_factor):
    """The sigmoid router with its correction bias and scale, relu² experts,
    the shared expert; capacity factor 0.5 makes the layer drop."""
    cfg, ref, _, w = small(capacity_factor=capacity_factor)
    p = w["layers"][1]["mlp"]
    assert set(p) == {"router", "router_bias", "wi_up", "wo", "shared"} and bool(p["router_bias"].abs().sum() > 0)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(2))
    with moe.record_routing() as calls:
        got, _ = moe.moe_apply(p, x, cfg)
    stats = []
    want = ref.moe(x, p, cfg, False, stats)
    assert torch.equal(calls[0]["expert_idx"], stats[0]["route"]["expert_idx"])
    assert torch.equal(calls[0]["keep"], stats[0]["route"]["keep"])
    assert (capacity_factor < 1) == (not bool(calls[0]["keep"].all()))
    assert rel(got, want) < F32_TOL
    # the recorded gap is the choice scores' margin at the top-k boundary
    torch.testing.assert_close(calls[0]["gap"][39::40], torch.tensor(stats[0]["margin"]), atol=1e-6, rtol=1e-6)


def test_moe_gates_are_the_raw_scores_renormalised_and_scaled():
    cfg, _, _, w = small()
    p = w["layers"][1]["mlp"]
    xf = torch.randn(16, cfg.d_model, generator=torch.Generator().manual_seed(4))
    scores, gates, idx, choice = moe.route_sigmoid(xf, p["router"], p["router_bias"], cfg.top_k, cfg.moe_routed_scale)
    assert torch.equal(idx, torch.topk(scores + p["router_bias"], cfg.top_k).indices)
    torch.testing.assert_close(gates.sum(-1), torch.full((16,), cfg.moe_routed_scale))
    torch.testing.assert_close(gates / cfg.moe_routed_scale * scores.gather(-1, idx).sum(-1, keepdim=True),
                               scores.gather(-1, idx))


def test_stack_prefill_logits_match_the_reference():
    cfg, ref, _, w = small()
    toks = tokens(cfg, 2, 64)
    with torch.no_grad():
        logits, _, caches = forward(Model(w), cfg, {"tokens": toks}, FLAGS, compute_dtype=torch.float32,
                                    want_cache=True)
    want = ref.last_logits(w, cfg, toks)
    assert rel(logits[:, -1], want) < F32_TOL
    assert [bool(c) for c in caches] == [c != "E" for c in PATTERN]  # a MoE layer holds no cache
    fp8 = ref.last_logits(w, cfg, toks, fp8=True)
    assert rel(fp8, want) > 10 * F32_TOL  # the control fails the tolerance


def test_prefill_then_decode_matches_the_full_forward():
    """Prefill 32 tokens, then decode 4 through the caches (KV, conv window
    and SSM state; nothing for the MoE layers); each step's logits against
    the reference's full forward over the sequence so far. The capacity
    factor leaves no assignment dropped, as a one-token decode drops none."""
    cfg, ref, _, w = small(capacity_factor=8.0)
    model = Model(w)
    seq = tokens(cfg, 2, 36, seed=7)
    with torch.no_grad():
        logits, _, caches = forward(model, cfg, {"tokens": seq[:, :32]}, FLAGS, compute_dtype=torch.float32,
                                    want_cache=True)
        caches = extend_cache(cfg, caches, 36)
        assert rel(logits[:, -1], ref.last_logits(w, cfg, seq[:, :32])) < F32_TOL
        for i in range(32, 36):
            step, caches = decode_step(model, cfg, caches, {"tokens": seq[:, i:i + 1]}, i, FLAGS,
                                       compute_dtype=torch.float32)
            assert rel(step[:, -1], ref.last_logits(w, cfg, seq[:, :i + 1])) < F32_TOL, i


def test_generate_serves_it_through_the_normal_path():
    from repro_torch.launch.serve import generate

    cfg, _, _, w = small()
    model = Model({k: v for k, v in w.items()})
    out, logits = generate(model, cfg, {"tokens": tokens(cfg, 1, 32)}, 3, flags=FLAGS)
    assert out.shape == (1, 3) and logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_init_params_lays_out_what_the_benchmark_draws():
    cfg, _, _, w = small()
    port = dict(init_params(cfg, 0, device="cpu").named_parameters())
    mine = dict(Model(w).named_parameters())
    assert sorted(port) == sorted(mine)
    for name, t in port.items():
        assert mine[name].shape == t.shape, name


def test_mesh_paths_refuse_the_new_kinds(monkeypatch):
    """The mesh paths carry the softmax router and gated experts only; the
    new kinds raise there, each named, rather than give another result."""
    from repro_torch.models import moe_shard_map

    cfg, _, _, w = small()
    with pytest.raises(NotImplementedError, match="moe_router='sigmoid', mlp_kind='relu2', moe_shared_d_ff"):
        moe_shard_map.moe_apply_shard_map(w["layers"][1]["mlp"], None, cfg, None, None)
    monkeypatch.setattr(moe, "current_context", lambda: ({}, None))
    with pytest.raises(NotImplementedError, match="moe_router='sigmoid'"):
        moe.moe_apply(w["layers"][1]["mlp"], torch.zeros(1, 4, cfg.d_model), cfg)
    softmax = dataclasses.replace(cfg, moe_router="softmax", mlp_kind="swiglu", moe_shared_d_ff=0)
    moe.mesh_kinds_unsupported(softmax)  # the defaults pass


@pytest.mark.parametrize("over", [dict(mlp_kinds=["dense"] * len(PATTERN)), dict(mlp_kind="swiglu")])
def test_init_refuses_the_kinds_no_configuration_has(over):
    """relu² is an expert kind only, and a shared expert is relu² only:
    ``init_params`` refuses a dense relu² layer and a gated shared expert."""
    cfg = dataclasses.replace(small()[0], **over)
    with pytest.raises(NotImplementedError, match="dense relu2|shared expert of kind 'swiglu'"):
        init_params(cfg, 0, device="cpu")


def test_defaults_keep_every_registered_architecture():
    """Every new field at its default on the ten registered architectures:
    the parameter trees and counts the reference's fields give."""
    for name, cfg in registry.ARCHS.items():
        assert (cfg.ssm_heads, cfg.ssm_groups, cfg.moe_router, cfg.moe_routed_scale, cfg.moe_shared_d_ff) == (
            0, 1, "softmax", 1.0, 0), name
        if cfg.has_mamba():
            assert cfg.ssm_d_inner == cfg.ssm_expand * cfg.d_model
    red = registry.reduced_config("qwen3-moe-235b-a22b")
    assert set(init_params(red, 0, device="cpu").tree()["layers"][0]["mlp"]) == {"router", "wi_gate", "wi_up", "wo"}
    assert math.isclose(registry.get_config("jamba-v0.1-52b").param_counts()["total"], 51.57e9, rel_tol=1e-2)
