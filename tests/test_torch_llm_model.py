"""The port's decoder against the reference's, on the reduced config of
every dense attention architecture and every MoE architecture (jamba,
qwen3-moe, grok-1), with the reference's initial weights carried across by
``convert.params_from_reference``.

``forward`` computes in f32 under every ``attn_impl``; logits agree within
1e-4 (absolute and relative): both packages do the same f32 arithmetic in
another summation order. The reference's ``"kernel"`` path needs the Pallas
kernel, which the CPU runs only in interpret mode, so the port's kernel
path (the plain version on the CPU) is held against the reference's
``"full"``. ``decode_step`` runs teacher-forced from an empty cache, in f32
with a bf16 cache and with an int8 cache. The bf16 cache rounds k and v
alike in both packages, but an f32 k that differs in its last bit can round
to the other bf16 neighbour: logits agree within 2e-3. With the int8 cache
the reference's source rounds the dequantized cache (int8 × scale) to bf16,
and XLA's default excess precision (``xla_allow_excess_precision``) skips
that rounding while the port keeps it. The bar there is the reference's own
decode bar (atol 5e-2, rtol 2e-2, ``tests/test_train_serve.py``); measured
differences reach 1.55e-2, and with the flag off the two agree to 1.5e-7.

On the MoE stacks each comparison first asserts that every MoE layer routed
every token alike (``expert_idx`` and ``keep`` identical, layer by layer),
so that a value outside its bar names a routing difference or rules one
out; the aux loss is held with the logits. The reference then runs eagerly
under ``jax.disable_jit`` (its scan over cycles a Python loop), so that each
``moe_apply`` call's routing can be read (``reference_routing``)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import reduced_config as ref_reduced  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.moe import record_routing  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from _torch_helpers import assert_same_config  # noqa: E402

DENSE = ["qwen3-1.7b", "gemma-7b", "starcoder2-7b", "mistral-large-123b", "qwen2-vl-2b",
         "musicgen-large"]
MOE = ["jamba-v0.1-52b", "qwen3-moe-235b-a22b", "grok-1-314b"]
B, S = 2, 16
FWD_TOL = 1e-4
DECODE_TOL = 2e-3
INT8_ATOL, INT8_RTOL = 5e-2, 2e-2


def reference_params(name, seed=0, dtype=jnp.float32, **overrides):
    """(port config, reference config, reference weights, the port's model
    holding them). Two cycles deep, so the per-layer unstacking matters;
    ``overrides`` replace config fields in both."""
    ref_cfg = ref_reduced(name)
    ref_cfg = dataclasses.replace(ref_cfg, n_layers=2 * ref_cfg.cycle_len, **overrides)
    cfg = dataclasses.replace(reduced_config(name), n_layers=ref_cfg.n_layers, **overrides)
    assert_same_config(cfg, ref_cfg)
    tree = RM.init_params(ref_cfg, jax.random.PRNGKey(seed), dtype=dtype)
    return cfg, ref_cfg, tree, params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


def batches(cfg, s=S, seed=0):
    """The same prompt for both packages: tokens, or embeddings (+ M-RoPE
    position streams for the VLM backbone)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        arrs = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    else:
        arrs = {"embeds": rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)}
        if cfg.rope_kind == "mrope":
            t = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s))
            hw = rng.integers(0, 4, (2, B, s)).astype(np.int32)
            arrs["mrope_positions"] = np.concatenate([t[None], hw], 0)
    ref = {k: jnp.asarray(v) for k, v in arrs.items()}
    port = {k: torch.from_numpy(np.array(v, dtype=np.int64 if v.dtype == np.int32 else v.dtype))
            for k, v in arrs.items()}
    return ref, port


def close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def reference_route(p, x, cfg):
    """The routing of the reference's ``moe_apply(p, x, cfg)``, by its own
    ops: (expert_idx (T, k), keep (T, k)) as numpy."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    logits = jnp.einsum("td,de->te", x.reshape(t, d).astype(jnp.float32), p["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    onehot = jax.nn.one_hot(idx.reshape(t * k), e, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    return np.asarray(idx), np.asarray(pos < RMoE.capacity(t, cfg)).reshape(t, k)


@contextlib.contextmanager
def reference_routing(on=True):
    """Run the reference eagerly inside the block and record the routing of
    each of its ``moe_apply`` calls, in call order, into the yielded list
    (``on=False``: nothing changes, the list stays empty)."""
    calls = []
    if not on:
        yield calls
        return

    def recording(p, x, cfg):
        calls.append(reference_route(p, x, cfg))
        return RMoE.moe_apply(p, x, cfg)

    RM.moe_apply = recording
    try:
        with jax.disable_jit():
            yield calls
    finally:
        RM.moe_apply = RMoE.moe_apply


def same_routing(port_calls, ref_calls):
    """Every MoE call routed every token alike in both packages."""
    assert len(port_calls) == len(ref_calls)
    for i, (got, (idx, keep)) in enumerate(zip(port_calls, ref_calls)):
        np.testing.assert_array_equal(got["expert_idx"].numpy(), idx, err_msg=f"expert_idx, call {i}")
        np.testing.assert_array_equal(got["keep"].numpy(), keep, err_msg=f"keep, call {i}")


@pytest.mark.parametrize("name", DENSE + MOE)
def test_forward_matches_reference(name):
    cfg, ref_cfg, tree, model = reference_params(name)
    rb, pb = batches(cfg)
    want, routes = {}, {}
    for impl in ("full", "blockwise"):
        flags = RM.RunFlags(attn_impl=impl, q_block=8, kv_block=8)
        with reference_routing(cfg.has_moe()) as routes[impl]:
            want[impl] = RM.forward(tree, ref_cfg, rb, flags, compute_dtype=jnp.float32)[:2]
    for impl, ref_impl in (("full", "full"), ("blockwise", "blockwise"), ("kernel", "full")):
        flags = PM.RunFlags(attn_impl=impl, q_block=8, kv_block=8)
        with record_routing() as calls:
            logits, aux, cache = PM.forward(model, cfg, pb, flags, compute_dtype=torch.float32)
        assert logits.dtype == torch.float32 and aux.dtype == torch.float32 and cache is None
        assert len(calls) == sum(cfg.mlp_kind_at(i % cfg.cycle_len) == "moe"
                                 for i in range(cfg.n_layers))
        same_routing(calls, routes[ref_impl])
        close(logits, want[ref_impl][0], FWD_TOL)
        close(aux, want[ref_impl][1], FWD_TOL)
        assert (float(aux) > 0) == cfg.has_moe()


@pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen2-vl-2b"])
def test_forward_hidden_cache_and_head(name):
    cfg, ref_cfg, tree, model = reference_params(name, seed=1)
    rb, pb = batches(cfg, seed=1)
    flags = RM.RunFlags(attn_impl="full")
    hid, _ = PM.forward_hidden(model, cfg, pb, PM.RunFlags(attn_impl="full"), torch.float32)
    close(hid, RM.forward_hidden(tree, ref_cfg, rb, flags, jnp.float32)[0], FWD_TOL)
    close(PM.head_matrix(model, cfg, torch.bfloat16), RM.head_matrix(tree, ref_cfg, jnp.bfloat16), 0)
    _, _, cache = PM.forward(model, cfg, pb, PM.RunFlags(attn_impl="kernel"), torch.float32, True)
    _, _, ref_cache = RM.forward(tree, ref_cfg, rb, flags, jnp.float32, want_cache=True)
    assert len(cache) == cfg.n_layers
    for i, c in enumerate(cache):  # layer i = cycle i // cycle_len, position i % cycle_len
        for key in ("k", "v"):
            close(c[key], ref_cache[i % cfg.cycle_len][key][i // cfg.cycle_len], FWD_TOL)


@pytest.mark.parametrize("name", DENSE + MOE)
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_decode_step_matches_reference(name, kv_quant):
    cfg, ref_cfg, tree, model = reference_params(name, seed=2)
    rb, pb = batches(cfg, s=6, seed=2)
    flags = RM.RunFlags(attn_impl="full")

    def ref_step(p, c, b, i):
        return RM.decode_step(p, ref_cfg, c, b, i, flags, jnp.float32)

    if not cfg.has_moe():
        ref_step = jax.jit(ref_step)
    # Jamba's Mamba-2 layers keep an f32 cache: the reference's decode
    # concatenates a bf16 conv window with the f32 token and carries the
    # promoted f32 window on, where the port shifts it in the cache's dtype
    # (``mamba2.mamba2_decode``); with a bf16 cache that departure, not the
    # MoE layers, moves the logits (0.04 at step 5)
    jdt, tdt = (jnp.float32, torch.float32) if cfg.has_mamba() else (jnp.bfloat16, torch.bfloat16)
    ref_cache = RM.init_cache(ref_cfg, B, 8, jdt, kv_quant)
    cache = PM.init_cache(cfg, B, 8, tdt, kv_quant, device="cpu")
    key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    for i in range(6):
        with reference_routing(cfg.has_moe()) as ref_calls:
            r_logits, ref_cache = ref_step(tree, ref_cache, {key: rb[key][:, i:i + 1]}, jnp.int32(i))
        with record_routing() as calls:
            logits, same = PM.decode_step(model, cfg, cache, {key: pb[key][:, i:i + 1]}, i,
                                          PM.RunFlags(attn_impl="full"), torch.float32)
        same_routing(calls, ref_calls)
        assert same is cache  # updated in place
        assert logits.shape == (B, 1, cfg.vocab_size)
        if kv_quant == "none":
            close(logits, r_logits, DECODE_TOL)
        else:
            np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=INT8_ATOL,
                                       rtol=INT8_RTOL)
    for c, rc_pos in ((cache[j], ref_cache[j % cfg.cycle_len]) for j in range(cfg.n_layers)):
        for k in c:
            got, want = c[k].float().numpy(), np.asarray(rc_pos[k][0], np.float32)
            assert got.dtype == want.dtype and got.shape == want.shape


def test_init_params_distributions_and_device():
    cfg = reduced_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            PM.init_params(cfg)
        raise RuntimeError("CUDA present: the default device is the card")
    a = PM.init_params(cfg, seed=3, device="cpu")
    b = PM.init_params(cfg, seed=3, device="cpu")
    ref = jax.tree.map(np.asarray, RM.init_params(ref_reduced("qwen3-1.7b"), jax.random.PRNGKey(0)))
    ta, tb = a.tree(), b.tree()
    assert torch.equal(ta["embed"], tb["embed"])  # seeded
    assert set(ta) == set(ref) and set(ta["layers"][0]) == set(ref["layers"][0])
    for key in ("wq", "wk", "wv", "wo"):
        w, rw = ta["layers"][0]["mixer"][key], ref["layers"][0]["mixer"][key][0]
        assert tuple(w.shape) == rw.shape
        assert abs(float(w.std()) - float(rw.std())) < 0.25 * float(rw.std())
    assert abs(float(ta["embed"].std()) - 0.02) < 2e-3
    assert float(ta["final_norm"].abs().max()) == 0.0
    bf = PM.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    cast = PM.cast_params(PM.init_params(cfg, seed=3, device="cpu"), torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16 and cast["final_norm"].dtype == torch.float32
    # per-layer norm scales round as the reference's (stacked, hence 2-D) ones do
    assert cast["layers"][0]["norm1"].dtype == torch.bfloat16


def test_unknown_flags_raise():
    cfg, _, _, model = reference_params("qwen3-1.7b")
    _, pb = batches(cfg)
    with pytest.raises(ValueError, match="attn_impl"):
        PM.forward(model, cfg, pb, PM.RunFlags(attn_impl="flash2"), torch.float32)
    with pytest.raises(ValueError, match="kv_quant"):
        PM.init_cache(cfg, 1, 4, kv_quant="fp8", device="cpu")
