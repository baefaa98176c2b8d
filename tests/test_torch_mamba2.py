"""The port's Mamba-2 serving path against the reference's, on reduced
mamba2-370m (two layers, d_model 64, 8 SSM heads of 16, state 16) with the
reference's weights carried across by ``convert.params_from_reference``,
and the repair of ``cast_params``.

The block (``mamba2_apply``, ``mamba2_decode``) and the stack (``forward``,
the prefill cache, teacher-forced ``decode_step``) run in f32, where both
packages do the same arithmetic in another summation order: within 1e-5
(absolute and relative; measured differences are below 1e-6). In bf16 the
two round at the same points, but XLA on the CPU may keep a fused chain (the
causal conv's shifted adds) in f32 where the port rounds each step, so bf16
outputs are held to the reference's prefill/decode bar (atol 5e-2, rtol
2e-2, ``tests/test_train_serve.py``), as the dense serving tests are. Each
comparison runs with both flag settings: the plain functions, and
``ssd_impl="kernel"``/``norm_impl="kernel"``, whose entry points run the
kernels' plain versions on CPU tensors (the launch counters must not move).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import reduced_config as ref_reduced  # noqa: E402
from repro.kernels.ssd.ref import ssd_reference as ref_ssd_reference  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.models import mamba2 as RB  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train.step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as NK  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.ssd import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_reference  # noqa: E402
from repro_torch.launch import serve as PS  # noqa: E402
from repro_torch.models import mamba2 as PB  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.convert import _tensor, params_from_reference  # noqa: E402
from repro_torch.train import step as PT  # noqa: E402
from test_torch_llm_model import batches, reference_params  # noqa: E402

F32_TOL = 1e-5
ATOL, RTOL = 5e-2, 2e-2
NAME = "mamba2-370m"
B, S = 2, 16
FLAGS = {"plain": PM.RunFlags(), "kernel": PM.RunFlags(ssd_impl="kernel", norm_impl="kernel")}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def close(port, ref, atol, rtol=None):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), atol=atol,
                               rtol=atol if rtol is None else rtol)


def close_at(port, ref, dt):
    if dt == "f32":
        close(port, ref, F32_TOL)
    else:
        close(port, ref, ATOL, RTOL)


@pytest.fixture
def no_launch():
    """CPU tensors never reach the CUDA kernels."""
    before = (SK.ssd_cuda.launches, NK.rmsnorm_cuda.launches)
    yield
    assert (SK.ssd_cuda.launches, NK.rmsnorm_cuda.launches) == before


def block_params(cfg, dt, seed=0):
    """The reference's ``mamba2_init`` block, with a non-zero conv bias, dt
    bias and norm scale made with numpy (zero at init), in both packages."""
    jdt, _ = DTYPES[dt]
    p = RB.mamba2_init(jax.random.PRNGKey(seed), cfg, jdt)
    rng = np.random.default_rng(seed)
    for key in ("conv_b", "dt_bias", "norm"):
        p[key] = jnp.asarray(rng.uniform(-0.5, 0.5, p[key].shape).astype(np.float32)).astype(p[key].dtype)
    return p, {k: _tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_block_apply_matches_reference(dt, impl, no_launch):
    cfg = reduced_config(NAME)
    jdt, tdt = DTYPES[dt]
    rp, pp = block_params(cfg, dt)
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want = RB.mamba2_apply(rp, jnp.asarray(x).astype(jdt), ref_reduced(NAME),
                           ssd_fn=partial(ref_ssd_reference, chunk=8))
    ssd_fn, norm = ((ssd, rmsnorm) if impl == "kernel" else (ssd_reference, PM.rms_norm))
    got = PB.mamba2_apply(pp, torch.from_numpy(x).to(tdt), cfg, partial(ssd_fn, chunk=8), norm)
    # the block's f32 SSM scalars promote its output as JAX promotes it
    assert str(got.dtype).split(".")[-1] == str(want.dtype) and got.shape == want.shape
    close_at(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block_prefill_cache_and_decode_match_reference(dt):
    """The prefill's cache (the last W-1 raw conv inputs and the SSD's final
    state, from the block's one SSD call) equals the reference's recomputed
    ``_mamba_prefill_cache``; then one-token decode steps, in place."""
    cfg, ref_cfg = reduced_config(NAME), ref_reduced(NAME)
    jdt, tdt = DTYPES[dt]
    rp, pp = block_params(cfg, dt, seed=2)
    x = np.random.default_rng(3).standard_normal((B, S + 4, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    flags = RM.RunFlags(ssd_chunk=8)
    ref_cache = RM._mamba_prefill_cache(rp, xj[:, :S], ref_cfg, flags)
    _, cache = PB.mamba2_prefill(pp, xt[:, :S], cfg, partial(ssd_reference, chunk=8))
    assert cache["conv"].dtype == tdt and cache["ssm"].dtype == torch.float32
    assert cache["conv"].shape == (B, cfg.ssm_conv_width - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state)
    close_at(cache["conv"], ref_cache["conv"], dt)
    close_at(cache["ssm"], ref_cache["ssm"], dt)
    same = cache["ssm"]
    for t in range(S, S + 4):
        want, ref_cache = RB.mamba2_decode(rp, xj[:, t:t + 1], ref_cache, ref_cfg)
        got, out_cache = PB.mamba2_decode(pp, xt[:, t:t + 1], cache, cfg)
        assert out_cache is cache and cache["ssm"] is same  # updated in place
        close_at(got, want, dt)
        close_at(cache["ssm"], ref_cache["ssm"], dt)
        close_at(cache["conv"], ref_cache["conv"], dt)


def test_short_prompt_cache_is_zero_padded():
    """A prompt shorter than the conv window leaves the window's older slots
    zero, as the causal conv pads them (the reference's slice cannot)."""
    cfg = reduced_config(NAME)
    _, pp = block_params(cfg, "f32")
    s, pad = 2, cfg.ssm_conv_width - 1 - 2
    x = torch.randn(B, s, cfg.d_model)
    _, cache = PB.mamba2_prefill(pp, x, cfg, partial(ssd_reference, chunk=s))
    assert cache["conv"].shape[1] == cfg.ssm_conv_width - 1 and not cache["conv"][:, :pad].any()
    raw = PB._split(cfg, PB._mm("bsd,de->bse", x, pp["in_proj"]))[1]
    assert torch.equal(cache["conv"][:, pad:], raw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_forward_and_prefill_cache_match_reference(dt, impl, no_launch):
    cfg, ref_cfg, tree, model = reference_params(NAME)
    jdt, tdt = DTYPES[dt]
    rb, pb = batches(cfg)
    rflags = RM.RunFlags(ssd_chunk=8)
    want, _, ref_cache = RM.forward(tree, ref_cfg, rb, rflags, compute_dtype=jdt, want_cache=True)
    flags = dataclasses.replace(FLAGS[impl], ssd_chunk=8)
    logits, aux, cache = PM.forward(model, cfg, pb, flags, compute_dtype=tdt, want_cache=True)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    close_at(logits, want, dt)
    assert len(cache) == cfg.n_layers
    for i, c in enumerate(cache):  # layer i = cycle i // cycle_len, position i % cycle_len
        rc = ref_cache[i % cfg.cycle_len]
        close_at(c["conv"], rc["conv"][i // cfg.cycle_len], dt)
        close_at(c["ssm"], rc["ssm"][i // cfg.cycle_len], dt)
    hidden, _ = PM.forward_hidden(model, cfg, pb, flags, tdt)
    close_at(hidden, RM.forward_hidden(tree, ref_cfg, rb, rflags, jdt)[0], dt)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_decode_step_matches_reference(impl, no_launch):
    """Prefill 12 tokens (``ssd_chunk`` 4: three chunks), extend, then
    teacher-forced decode of the rest, in f32, against the reference's
    steps."""
    cfg, ref_cfg, tree, model = reference_params(NAME, seed=2)
    rb, pb = batches(cfg, seed=2)
    rflags, flags = RM.RunFlags(ssd_chunk=4), dataclasses.replace(FLAGS[impl], ssd_chunk=4)
    s0 = 12
    _, _, ref_cache = RM.forward(tree, ref_cfg, {"tokens": rb["tokens"][:, :s0]}, rflags,
                                 compute_dtype=jnp.float32, want_cache=True)
    ref_cache = RS.extend_cache(ref_cfg, ref_cache, S)
    _, _, cache = PM.forward(model, cfg, {"tokens": pb["tokens"][:, :s0]}, flags,
                             compute_dtype=torch.float32, want_cache=True)
    cache = PS.extend_cache(cfg, cache, S)
    for i in range(s0, S):
        r_logits, ref_cache = RM.decode_step(tree, ref_cfg, ref_cache, {"tokens": rb["tokens"][:, i:i + 1]},
                                             jnp.int32(i), rflags, jnp.float32)
        logits, same = PM.decode_step(model, cfg, cache, {"tokens": pb["tokens"][:, i:i + 1]}, i, flags,
                                      torch.float32)
        assert same is cache
        close(logits, r_logits, F32_TOL)
    for j, c in enumerate(cache):
        for key in ("conv", "ssm"):
            close(c[key], ref_cache[j % cfg.cycle_len][key][j // cfg.cycle_len], F32_TOL)


def test_init_cache_layout():
    cfg = dataclasses.replace(reduced_config(NAME), n_layers=2)
    cache = PM.init_cache(cfg, B, 32, torch.bfloat16, device="cpu")
    ref = RM.init_cache(dataclasses.replace(ref_reduced(NAME), n_layers=2), B, 32, jnp.bfloat16)
    assert len(cache) == 2
    for j, c in enumerate(cache):
        assert set(c) == set(ref[0]) == {"conv", "ssm"}
        for key, t in c.items():
            want = ref[j % cfg.cycle_len][key][j // cfg.cycle_len]
            assert tuple(t.shape) == want.shape and not t.any()
            assert str(t.dtype).split(".")[-1] == str(want.dtype)


@pytest.fixture(scope="module")
def served():
    """The reference's bf16 generate on reduced mamba2-370m (embedding scaled
    by 4, so the logits spread and greedy tokens decide something; the
    largest difference is then under half the bar), and its per-step logits
    fed its own tokens."""
    ref_cfg = dataclasses.replace(ref_reduced(NAME), n_layers=2)
    cfg = dataclasses.replace(reduced_config(NAME), n_layers=2)
    tree = RM.init_params(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tree["embed"] = tree["embed"] * 4
    model = params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")
    s0, n = 8, 6
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, s0)).astype(np.int32)
    flags = RM.RunFlags(ssd_chunk=8)
    ref_tokens, _ = RS.generate(tree, ref_cfg, {"tokens": jnp.asarray(prompt)}, n_tokens=n, flags=flags)
    ref_tokens = np.asarray(ref_tokens)
    prefill, decode = jax.jit(make_prefill_step(ref_cfg, flags)), jax.jit(make_decode_step(ref_cfg, flags))
    logits, cache = prefill(tree, {"tokens": jnp.asarray(prompt)})
    cache = RS.extend_cache(ref_cfg, cache, s0 + n)
    ref_logits = [np.asarray(logits)]
    for i in range(n - 1):
        logits, cache = decode(tree, cache, {"tokens": jnp.asarray(ref_tokens[:, i:i + 1])},
                               jnp.int32(s0 + i))
        ref_logits.append(np.asarray(logits))
    return cfg, model, prompt, ref_tokens, np.stack(ref_logits, 1)


def wide_margin(ref_logits):
    top2 = np.sort(ref_logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * (ATOL + RTOL * np.abs(top2[..., 1]))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_serving_steps_match_reference(served, impl, no_launch):
    """Teacher-forced prefill and decode steps in bf16 at the reference's
    bar, greedy tokens where the reference's margin is wide, and
    ``generate``'s own tokens up to the first narrow step."""
    cfg, model, prompt, ref_tokens, ref_logits = served
    s0, n = prompt.shape[1], ref_tokens.shape[1]
    flags = dataclasses.replace(FLAGS[impl], ssd_chunk=8)
    prefill, decode = PT.make_prefill_step(cfg, flags), PT.make_decode_step(cfg, flags)
    with torch.inference_mode():
        logits, cache = prefill(model, {"tokens": torch.from_numpy(prompt).long()})
        cache = PS.extend_cache(cfg, cache, s0 + n)
        got = [logits]
        for i in range(n - 1):
            tok = torch.tensor(ref_tokens[:, i:i + 1], dtype=torch.long)
            logits, cache = decode(model, cache, {"tokens": tok}, s0 + i)
            got.append(logits)
    got = torch.stack(got, 1).numpy()
    np.testing.assert_allclose(got, ref_logits, atol=ATOL, rtol=RTOL)
    wide = wide_margin(ref_logits)
    assert wide.any()
    assert np.array_equal(got.argmax(-1)[wide], ref_tokens[wide])
    tokens, last = PS.generate(model, cfg, {"tokens": torch.from_numpy(prompt).long()}, n, flags=flags)
    assert tokens.shape == (B, n) and torch.isfinite(last).all()
    for b in range(B):
        n_sure = int(np.argmin(wide[b])) if not wide[b].all() else n
        assert np.array_equal(tokens[b, :n_sure].numpy(), ref_tokens[b, :n_sure]), (b, n_sure)


def test_params_from_reference_carries_mamba_leaves():
    cfg, ref_cfg, tree, model = reference_params(NAME, seed=4)
    leaves = {"in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm", "out_proj"}
    t = model.tree()
    assert len(t["layers"]) == cfg.n_layers and set(t) == set(tree)
    for j, layer in enumerate(t["layers"]):
        assert set(layer) == {"norm1", "mixer"} and set(layer["mixer"]) == leaves
        want = tree["layers"][j % cfg.cycle_len]["mixer"]
        for key in leaves:
            np.testing.assert_array_equal(layer["mixer"][key].numpy(),
                                          np.asarray(want[key][j // cfg.cycle_len]))


def test_init_params_distributions():
    cfg = dataclasses.replace(reduced_config(NAME), n_layers=2)
    ref_cfg = dataclasses.replace(ref_reduced(NAME), n_layers=2)
    ref = jax.tree.map(np.asarray, RM.init_params(ref_cfg, jax.random.PRNGKey(0)))
    t = PM.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu").tree()
    assert set(t) == set(ref) and "lm_head" not in t  # tied embeddings
    for layer in t["layers"]:
        m, rm = layer["mixer"], ref["layers"][0]["mixer"]
        assert set(m) == set(rm)
        for key, w in m.items():
            assert tuple(w.shape) == rm[key].shape[1:], key
            f32 = key in ("a_log", "d_skip", "dt_bias")  # f32 whatever the dtype, as in the reference
            assert w.dtype == (torch.float32 if f32 else torch.bfloat16), key
        for key in ("a_log", "d_skip", "dt_bias"):
            np.testing.assert_allclose(m[key].numpy(), rm[key][0], rtol=1e-6)
        for key in ("in_proj", "conv_w", "out_proj"):
            std, rstd = float(m[key].float().std()), float(rm[key].std())
            assert abs(std - rstd) < 0.25 * rstd, key
        assert not m["conv_b"].any() and not m["norm"].any() and not layer["norm1"].any()


def nonzero_scales(tree, seed):
    """Every norm scale, conv bias and SSM scalar of a reference tree drawn
    anew with numpy (non-zero, with many mantissa bits), in f32."""
    rng = np.random.default_rng(seed)
    names = ("norm", "conv_b", "a_log", "d_skip", "dt_bias")

    def draw(path, a):
        name = str(path[-1])
        if any(n in name for n in names):
            return jnp.asarray(rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)) + (
                1.0 if "a_log" in name or "d_skip" in name else 0.0)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.mark.parametrize("name", ["qwen3-1.7b", NAME])
def test_cast_params_rounds_what_the_reference_rounds(name):
    """The repair of the mixed-precision policy: the reference stacks each
    per-layer tensor over cycles before it casts by rank, so under a bf16
    compute dtype every f32 norm scale and SSM scalar of the layers is cast
    and only the top-level ``final_norm`` keeps f32. With non-zero scales
    (zero at init, which hid the difference), the port's cast tree equals
    the reference's bit for bit, and the bf16 logits (qwen3: qk-norm on)
    agree at the reference's bar."""
    cfg, ref_cfg, tree, _ = reference_params(name)
    tree = nonzero_scales(tree, seed=5)
    model = params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")
    got, want = PM.cast_params(model, torch.bfloat16), RM.cast_params(tree, jnp.bfloat16)
    for j, layer in enumerate(got["layers"]):
        ref_layer = jax.tree.map(lambda a, j=j: np.asarray(a[j // cfg.cycle_len]),
                                 want["layers"][j % cfg.cycle_len])
        flat, ref_flat = jax.tree_util.tree_leaves_with_path(layer), jax.tree_util.tree_leaves_with_path(ref_layer)
        assert [p for p, _ in flat] == [p for p, _ in ref_flat]
        for (path, t), (_, r) in zip(flat, ref_flat):
            assert str(t.dtype).split(".")[-1] == str(r.dtype), path
            np.testing.assert_array_equal(t.float().numpy(), r.astype(np.float32))
    assert got["final_norm"].dtype == torch.float32 and got["embed"].dtype == torch.bfloat16
    rb, pb = batches(cfg, seed=5)
    rflags, flags = RM.RunFlags(attn_impl="full", ssd_chunk=8), PM.RunFlags(attn_impl="full", ssd_chunk=8)
    r_logits = RM.forward(tree, ref_cfg, rb, rflags, compute_dtype=jnp.bfloat16)[0]
    logits = PM.forward(model, cfg, pb, flags, compute_dtype=torch.bfloat16)[0]
    close(logits, r_logits, ATOL, RTOL)


def test_unknown_kernel_flags_raise():
    cfg, _, _, model = reference_params(NAME)
    _, pb = batches(cfg)
    with pytest.raises(ValueError, match="ssd_impl"):
        PM.forward(model, cfg, pb, PM.RunFlags(ssd_impl="triton"), torch.float32)
    with pytest.raises(ValueError, match="norm_impl"):
        PM.forward(model, cfg, pb, PM.RunFlags(norm_impl="fused"), torch.float32)
    with pytest.raises(ValueError, match="divide"):  # chunk = min(ssd_chunk, S) must divide S
        PM.forward(model, cfg, {"tokens": pb["tokens"][:, :12]}, PM.RunFlags(ssd_chunk=8), torch.float32)
