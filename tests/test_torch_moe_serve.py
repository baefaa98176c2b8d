"""Serving the MoE stacks: the port's ``decode_step`` and
``launch.serve.generate`` against the reference's, with the reference's
weights carried across by ``convert.params_from_reference``.

Teacher-forced decode runs in f32 at B = 4 with the capacity factor cut to
0.5, so C = max(k, ⌈4·2·0.5/4⌉) = 2 and an expert chosen by three of the
four tokens drops one, as full-width Jamba drops at B = 4 (C = 2): routing
identical step by step and layer by layer, drops asserted, logits within
2e-3 (the decode bar of ``tests/test_torch_llm_model.py``; Jamba's Mamba-2
layers keep an f32 cache, as there).

``generate`` runs reduced Jamba (one cycle: attention, Mamba-2, dense and
MoE layers) in bf16 with the embedding scaled by 4, so greedy tokens decide
something, on the pattern of ``tests/test_torch_mamba2.py``: per-step logits
teacher-forced on the reference's tokens at the reference's serving bar
(atol 5e-2, rtol 2e-2), each step's routing identical, greedy tokens where
the reference's margin exceeds twice the bar, ``generate``'s own tokens up
to the first narrow step; both flag settings (the plain functions, and
every kernel switch on, whose entry points run the kernels' plain versions
on CPU tensors: the launch counters must not move).

The reference runs eagerly there (``jax.disable_jit``: ``generate`` and each
step), rounding to bf16 where its source rounds. Jitted, XLA on the CPU
keeps fused chains in f32 (excess precision) and departs from its own
source: on this prompt its prefill logits differ from its eager ones by
0.069 (0.061 with every MLP removed, so not from the MoE layers), past the
bar at some elements, while the port's differ from the eager ones by 2.4e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import reduced_config as ref_reduced  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train.step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as NK  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.launch import serve as PS  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.moe import record_routing  # noqa: E402
from repro_torch.train import step as PT  # noqa: E402
from test_torch_llm_model import (  # noqa: E402
    MOE,
    reference_params,
    reference_routing,
    same_routing,
)

DECODE_TOL = 2e-3
ATOL, RTOL = 5e-2, 2e-2
JAMBA = "jamba-v0.1-52b"
FLAGS = {"plain": PM.RunFlags(ssd_chunk=8),
         "kernel": PM.RunFlags(attn_impl="kernel", ssd_impl="kernel", norm_impl="kernel",
                               ssd_chunk=8)}


def launches():
    return FK.flash_attention_cuda.launches, SK.ssd_cuda.launches, NK.rmsnorm_cuda.launches


@pytest.mark.parametrize("name", MOE)
def test_decode_with_capacity_drops_matches_reference(name):
    b, n = 4, 6
    cfg, ref_cfg, tree, model = reference_params(name, seed=7, capacity_factor=0.5)
    rb = {"tokens": jnp.asarray(np.random.default_rng(7).integers(0, cfg.vocab_size, (b, n)),
                                jnp.int32)}
    pb = {"tokens": torch.from_numpy(np.array(rb["tokens"])).long()}
    flags = RM.RunFlags(attn_impl="full")
    ref_cache = RM.init_cache(ref_cfg, b, 8, jnp.float32)
    cache = PM.init_cache(cfg, b, 8, torch.float32, device="cpu")
    dropped = 0
    for i in range(n):
        with reference_routing() as ref_calls:
            r_logits, ref_cache = RM.decode_step(tree, ref_cfg, ref_cache,
                                                 {"tokens": rb["tokens"][:, i:i + 1]},
                                                 jnp.int32(i), flags, jnp.float32)
        with record_routing() as calls:
            logits, _ = PM.decode_step(model, cfg, cache, {"tokens": pb["tokens"][:, i:i + 1]}, i,
                                       PM.RunFlags(attn_impl="full"), torch.float32)
        same_routing(calls, ref_calls)
        dropped += sum(int((~c["keep"]).sum()) for c in calls)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
    assert dropped > 0  # capacity drops took part


@pytest.fixture(scope="module")
def served():
    """The reference's eager bf16 generate on reduced Jamba, its per-step
    logits fed its own tokens, and each step's routing."""
    ref_cfg, cfg = ref_reduced(JAMBA), reduced_config(JAMBA)
    tree = RM.init_params(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tree["embed"] = tree["embed"] * 4
    model = params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")
    b, s0, n = 2, 8, 6
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s0)).astype(np.int32)
    flags = RM.RunFlags(ssd_chunk=8)
    with jax.disable_jit():
        ref_tokens, _ = RS.generate(tree, ref_cfg, {"tokens": jnp.asarray(prompt)}, n_tokens=n,
                                    flags=flags)
    ref_tokens = np.asarray(ref_tokens)
    prefill, decode = make_prefill_step(ref_cfg, flags), make_decode_step(ref_cfg, flags)
    routes = [[]]
    with reference_routing() as routes[0]:
        logits, cache = prefill(tree, {"tokens": jnp.asarray(prompt)})
    cache = RS.extend_cache(ref_cfg, cache, s0 + n)
    ref_logits = [np.asarray(logits)]
    for i in range(n - 1):
        routes.append([])
        with reference_routing() as routes[-1]:
            logits, cache = decode(tree, cache, {"tokens": jnp.asarray(ref_tokens[:, i:i + 1])},
                                   jnp.int32(s0 + i))
        ref_logits.append(np.asarray(logits))
    return cfg, model, prompt, ref_tokens, np.stack(ref_logits, 1), routes


def wide_margin(ref_logits):
    top2 = np.sort(ref_logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * (ATOL + RTOL * np.abs(top2[..., 1]))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_jamba_serving_matches_reference(served, impl):
    cfg, model, prompt, ref_tokens, ref_logits, routes = served
    s0, n = prompt.shape[1], ref_tokens.shape[1]
    flags = FLAGS[impl]
    before = launches()
    prefill, decode = PT.make_prefill_step(cfg, flags), PT.make_decode_step(cfg, flags)
    with torch.inference_mode():
        with record_routing() as calls:
            logits, cache = prefill(model, {"tokens": torch.from_numpy(prompt).long()})
        same_routing(calls, routes[0])
        cache = PS.extend_cache(cfg, cache, s0 + n)
        got = [logits]
        for i in range(n - 1):
            tok = torch.tensor(ref_tokens[:, i:i + 1], dtype=torch.long)
            with record_routing() as calls:
                logits, cache = decode(model, cache, {"tokens": tok}, s0 + i)
            same_routing(calls, routes[i + 1])
            got.append(logits)
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, ref_logits, atol=ATOL, rtol=RTOL)
    wide = wide_margin(ref_logits)
    assert wide.any()
    assert np.array_equal(got.argmax(-1)[wide], ref_tokens[wide])
    tokens, last = PS.generate(model, cfg, {"tokens": torch.from_numpy(prompt).long()}, n,
                               flags=flags)
    assert tokens.shape == (prompt.shape[0], n) and torch.isfinite(last).all()
    for row in range(prompt.shape[0]):
        n_sure = int(np.argmin(wide[row])) if not wide[row].all() else n
        assert np.array_equal(tokens[row, :n_sure].numpy(), ref_tokens[row, :n_sure]), (row, n_sure)
    assert launches() == before  # CPU tensors run the kernels' plain versions


def test_jamba_generate_zero_tokens_is_the_prefill(served):
    cfg, model, prompt, _, ref_logits, _ = served
    toks = {"tokens": torch.from_numpy(prompt).long()}
    tokens, last = PS.generate(model, cfg, toks, 0, flags=FLAGS["kernel"])
    with torch.inference_mode():
        want, cache = PT.make_prefill_step(cfg, FLAGS["kernel"])(model, toks)
    assert tokens.shape == (prompt.shape[0], 0) and torch.equal(last, want)
    assert len(cache) == cfg.n_layers
    assert {k for c in cache for k in c} == {"k", "v", "conv", "ssm"}
    np.testing.assert_allclose(last.numpy(), ref_logits[:, 0], atol=ATOL, rtol=RTOL)


def test_reduced_jamba_runs_every_block_kind():
    """One cycle of reduced Jamba holds an attention layer, seven Mamba-2
    layers, four MoE and four dense channel mixers, as the full config."""
    cfg = reduced_config(JAMBA)
    assert cfg.n_layers == cfg.cycle_len == 8
    assert cfg.block_kinds.count("attn") == 1 and cfg.block_kinds.count("mamba") == 7
    assert [cfg.mlp_kind_at(p) for p in range(8)].count("moe") == 4
    m = PM.init_params(dataclasses.replace(cfg, n_layers=8), seed=0, dtype=torch.bfloat16,
                       device="cpu")
    kinds = [("wq" in lay["mixer"], "router" in lay["mlp"]) for lay in m.tree()["layers"]]
    assert kinds[3] == (True, True) and kinds[0] == (False, False) and kinds[1] == (False, True)


def test_serve_moe_phase_rehearses_on_the_cpu(capsys):
    """``chip_smoke.serve_moe_phase`` end to end on the CPU at reduced size
    (no launches are counted and no host sync is checked there): one
    ``serve_moe`` line a model, Jamba's end-to-end comparison held, and the
    launch counts it would hold on the card (24 RMSNorm a Jamba call, 17 a
    4-layer Qwen3-MoE call; a position-in-expert call an MoE layer a call,
    4 in each)."""
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS

    jamba = reduced_config(JAMBA)
    qwen = dataclasses.replace(reduced_config("qwen3-moe-235b-a22b"), n_layers=4)
    assert CS.moe_want_launches(jamba, 33) == {"flash": 1, "ssd": 7, "rmsnorm": 792, "moe_positions": 132}
    assert CS.moe_want_launches(qwen, 33) == {"flash": 4, "ssd": 0, "rmsnorm": 561, "moe_positions": 132}
    out = CS.serve_moe_phase("cpu", models=[(jamba, 4), (qwen, 0)], device="cpu", batch=4,
                             prompt_len=32, new=2, profile=False)
    assert set(out) == {jamba.name, qwen.name}
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [d["model"] for d in lines] == [jamba.name, qwen.name]
    for d in lines:
        assert d["phase"] == "serve_moe" and d["ok"] and d["params_device"] == "cpu"
        assert len(d["layerwise"]) == d["layers"]
        assert all(r["within_bar_routed_alike"] for r in d["layerwise"])
    assert set(lines[0]["plain"]) == {"held", "all"} and set(lines[1]["plain"]) == {"all"}
    assert lines[0]["want_launches"] == {"flash": 1, "ssd": 7, "rmsnorm": 24 * 3, "moe_positions": 4 * 3}
