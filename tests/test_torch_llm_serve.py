"""The port's serving path (``launch.serve.generate``: prefill, cache
extension, greedy decode) against the reference's, on reduced qwen3-1.7b
with the reference's bf16 weights carried across. The embedding (tied to
the LM head) is scaled by 8, so the logits spread beyond the bar and
greedy tokens decide something.

Both packages compute in bf16. Per-step logits are compared teacher-forced
on the reference's generated tokens (prefill, then one decode step per
token), at the reference's own prefill/decode bar (atol 5e-2, rtol 2e-2,
``tests/test_train_serve.py``). Greedy tokens can differ legitimately where
the reference's top two logits are closer than the two packages may be
apart, so tokens are compared only where that margin exceeds twice the bar:
teacher-forced at every such step, and for ``generate`` itself up to the
first step where it does not. Measured: the largest difference is about
half the bar, and 9 of the 12 steps have the wide margin."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import reduced_config as ref_reduced  # noqa: E402
from repro.launch import serve as RS  # noqa: E402
from repro.models.model import RunFlags as RefFlags  # noqa: E402
from repro.models.model import init_params as ref_init  # noqa: E402
from repro.train.step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.launch import serve as PS  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import RunFlags  # noqa: E402
from repro_torch.train import step as PT  # noqa: E402

ATOL, RTOL = 5e-2, 2e-2
B, S0, N = 2, 8, 6


@pytest.fixture(scope="module")
def setup():
    ref_cfg, cfg = ref_reduced("qwen3-1.7b"), reduced_config("qwen3-1.7b")
    tree = ref_init(ref_cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tree["embed"] = tree["embed"] * 8
    model = params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)
    flags = RefFlags(attn_impl="full")
    ref_tokens, _ = RS.generate(tree, ref_cfg, {"tokens": jnp.asarray(prompt)}, n_tokens=N, flags=flags)
    ref_tokens = np.asarray(ref_tokens)
    # the reference's per-step logits, fed its own tokens (what generate saw)
    prefill, decode = jax.jit(make_prefill_step(ref_cfg, flags)), jax.jit(make_decode_step(ref_cfg, flags))
    logits, cache = prefill(tree, {"tokens": jnp.asarray(prompt)})
    cache = RS.extend_cache(ref_cfg, cache, S0 + N)
    ref_logits = [np.asarray(logits)]
    for i in range(N - 1):
        logits, cache = decode(tree, cache, {"tokens": jnp.asarray(ref_tokens[:, i:i + 1])},
                               jnp.int32(S0 + i))
        ref_logits.append(np.asarray(logits))
    return cfg, model, prompt, ref_tokens, np.stack(ref_logits, 1)  # (B, N, V)


def wide_margin(ref_logits):
    """Steps where the reference's top-1 leads its top-2 by more than twice
    the bar."""
    top2 = np.sort(ref_logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * (ATOL + RTOL * np.abs(top2[..., 1]))


def test_reference_tokens_are_its_logits_argmax(setup):
    _, _, _, ref_tokens, ref_logits = setup
    assert np.array_equal(ref_logits.argmax(-1), ref_tokens)


@pytest.mark.parametrize("impl", ["kernel", "full"])
def test_teacher_forced_logits_match(setup, impl):
    cfg, model, prompt, ref_tokens, ref_logits = setup
    flags = RunFlags(attn_impl=impl)
    prefill, decode = PT.make_prefill_step(cfg, flags), PT.make_decode_step(cfg, flags)
    with torch.inference_mode():
        logits, cache = prefill(model, {"tokens": torch.from_numpy(prompt).long()})
        cache = PS.extend_cache(cfg, cache, S0 + N)
        got = [logits]
        for i in range(N - 1):
            tok = torch.tensor(ref_tokens[:, i:i + 1], dtype=torch.long)
            logits, cache = decode(model, cache, {"tokens": tok}, S0 + i)
            got.append(logits)
    got = torch.stack(got, 1).numpy()
    assert got.dtype == np.float32 and got.shape == ref_logits.shape
    np.testing.assert_allclose(got, ref_logits, atol=ATOL, rtol=RTOL)
    wide = wide_margin(ref_logits)
    assert wide.any()
    assert np.array_equal(got.argmax(-1)[wide], ref_tokens[wide])


def test_generate_matches_reference_tokens(setup):
    cfg, model, prompt, ref_tokens, ref_logits = setup
    launches = K.flash_attention_cuda.launches
    tokens, last = PS.generate(model, cfg, {"tokens": torch.from_numpy(prompt).long()}, N,
                               flags=RunFlags(attn_impl="kernel"))
    assert K.flash_attention_cuda.launches == launches  # CPU tensors run the plain version
    assert tokens.shape == (B, N) and last.shape == (B, cfg.vocab_size)
    assert bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()) and torch.isfinite(last).all()
    wide = wide_margin(ref_logits)
    for b in range(B):
        n_sure = int(np.argmin(wide[b])) if not wide[b].all() else N
        assert np.array_equal(tokens[b, :n_sure].numpy(), ref_tokens[b, :n_sure]), (b, n_sure)


def test_generate_zero_tokens_is_the_prefill(setup):
    cfg, model, prompt, _, ref_logits = setup
    toks = {"tokens": torch.from_numpy(prompt).long()}
    tokens, last = PS.generate(model, cfg, toks, 0, flags=RunFlags(attn_impl="kernel"))
    with torch.inference_mode():
        want, _ = PT.make_prefill_step(cfg, RunFlags(attn_impl="kernel"))(model, toks)
    assert tokens.shape == (B, 0) and tokens.dtype == torch.long
    assert torch.equal(last, want)
    np.testing.assert_allclose(last.numpy(), ref_logits[:, 0], atol=ATOL, rtol=RTOL)


def test_extend_cache_and_device_checks(setup):
    cfg, model, prompt, _, _ = setup
    with torch.inference_mode():
        _, cache = PT.make_prefill_step(cfg, RunFlags(attn_impl="full"))(
            model, {"tokens": torch.from_numpy(prompt).long()})
    ext = PS.extend_cache(cfg, cache, S0 + 4)
    assert ext[0]["k"].shape == (B, S0 + 4, cfg.n_kv_heads, cfg.head_dim)
    assert torch.equal(ext[0]["k"][:, :S0], cache[0]["k"]) and not ext[0]["k"][:, S0:].any()
    with pytest.raises(ValueError, match="capacity"):
        PS.extend_cache(cfg, cache, S0 - 1)
    with pytest.raises(ValueError, match="model on"):
        PS.generate(model, cfg, {"tokens": torch.from_numpy(prompt).long().to("meta")}, 2)
