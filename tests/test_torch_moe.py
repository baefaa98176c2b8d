"""The port's MoE layer (``models.moe``) against the reference's
(``repro.models.moe``), and the MoE plumbing of the port's decoder, on the
reduced configs of the three MoE architectures (jamba: 4 experts top-2
SwiGLU behind a hybrid stack; qwen3-moe: the same routing behind qk-norm
attention; grok-1: the same on a uniform attention stack).

``moe_apply`` runs on the same weights and tokens in both packages, in f32:
routing (``expert_idx`` and ``keep``) first, identical, then y and the aux
loss within 1e-5 (both do the same f32 arithmetic in another summation
order). The ``drops`` cases cut the capacity factor to 0.5 (C = 8 for 64
assignments over 4 experts), so capacity drops take part; the test asserts
they happen. In bf16 the same inputs are held to the reference's serving
bar (atol 5e-2, rtol 2e-2): at k = 2 the combine is a single add, rounded
once in both. A top-8 combine in bf16 (qwen3-moe at full width) is not held
against JAX: both sum in f32 and round once, in orders that differ.

The stack's aux loss under ``remat`` ("full", "dots") equals the one
without, and its f32 gradient on reduced qwen3-moe lies within 1e-5 of
``jax.grad``'s, every parameter leaf.

The position-in-expert wrapper (``kernels.moe_positions``) on CPU and meta
tensors: a hand-worked case, the reference's one-hot formula on random ids,
the meta path's shape and dtype, and the refusals it shares with the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import reduced_config as ref_reduced  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.moe_positions import moe_positions  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models import moe as PMoE  # noqa: E402
from repro_torch.models.convert import _tensor, params_from_reference  # noqa: E402
from _torch_helpers import assert_same_config  # noqa: E402
from test_torch_llm_model import (  # noqa: E402
    MOE,
    batches,
    reference_params,
    reference_route,
    reference_routing,
    same_routing,
)

F32_TOL = 1e-5
ATOL, RTOL = 5e-2, 2e-2
B, S = 2, 16
CASES = {"capacity": {}, "drops": {"capacity_factor": 0.5}}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(name, **overrides):
    ref_cfg = dataclasses.replace(ref_reduced(name), **overrides)
    cfg = dataclasses.replace(reduced_config(name), **overrides)
    assert_same_config(cfg, ref_cfg)
    return cfg, ref_cfg


def layer_inputs(ref_cfg, dt, seed):
    """The reference's ``moe_init`` weights and seeded numpy tokens, in both
    packages."""
    jdt, _ = DTYPES[dt]
    p = RMoE.moe_init(jax.random.PRNGKey(seed), ref_cfg, jdt)
    x = np.random.default_rng(seed).standard_normal((B, S, ref_cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    pt = {k: _tensor(np.asarray(v)) for k, v in p.items()}
    return p, xj, pt, _tensor(np.asarray(xj))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_matches_reference(name, case, dt):
    cfg, ref_cfg = configs(name, **CASES[case])
    p, xj, pt, xt = layer_inputs(ref_cfg, dt, seed=MOE.index(name))
    want_y, want_aux = RMoE.moe_apply(p, xj, ref_cfg)
    idx, keep = reference_route(p, xj, ref_cfg)
    with PMoE.record_routing() as calls:
        y, aux = PMoE.moe_apply(pt, xt, cfg)
    same_routing(calls, [(idx, keep)])
    assert y.dtype == xt.dtype and y.shape == xt.shape and aux.dtype == torch.float32
    if case == "drops":
        assert not keep.all()  # capacity drops take part
    atol, rtol = (F32_TOL, F32_TOL) if dt == "f32" else (ATOL, RTOL)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n_tokens", [1, 2, 4, 7, 32, 2048])
@pytest.mark.parametrize("name", MOE)
def test_capacity_matches_reference(name, n_tokens):
    for cfg, ref_cfg in (configs(name), (get_config(name), get_config(name))):
        assert PMoE.capacity(n_tokens, cfg) == RMoE.capacity(n_tokens, ref_cfg)


def test_decode_capacity_at_the_serving_batch():
    """Full-width Jamba at decode with B = 4: C = max(k, min(⌈4·2·1.25/16⌉,
    4)) = 2, so an expert chosen by three of the four tokens drops one."""
    assert PMoE.capacity(4, get_config("jamba-v0.1-52b")) == 2
    assert PMoE.capacity(4 * 512, get_config("jamba-v0.1-52b")) == 320
    assert PMoE.capacity(4, get_config("qwen3-moe-235b-a22b")) == 8


def test_dropped_assignments_add_zeros_to_slot_zero():
    """A skewed router (positive tokens; the router's columns 0 and 1
    positive, the rest zero) sends every token to experts 0 and 1, far past
    capacity: the first C tokens are kept, the rest get nothing back, and
    the zero rows the dropped ones add to slot 0 change nothing there."""
    cfg, ref_cfg = configs("grok-1-314b", capacity_factor=0.25)
    p, xj, pt, xt = layer_inputs(ref_cfg, "f32", seed=5)
    xj, xt = jnp.abs(xj), xt.abs()
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 0], router[:, 1] = 2e-3, 1e-3
    p, pt["router"] = dict(p, router=jnp.asarray(router)), torch.from_numpy(router)
    with PMoE.record_routing() as calls:
        y, _ = PMoE.moe_apply(pt, xt, cfg)
    same_routing(calls, [reference_route(p, xj, ref_cfg)])
    keep, c = calls[0]["keep"], PMoE.capacity(B * S, cfg)
    assert (calls[0]["expert_idx"] == torch.tensor([0, 1])).all()
    assert keep[:c].all() and not keep[c:].any()  # earlier tokens win capacity
    np.testing.assert_allclose(y.numpy(), np.asarray(RMoE.moe_apply(p, xj, ref_cfg)[0]),
                               atol=F32_TOL, rtol=F32_TOL)
    # tokens past capacity in both of their experts get nothing back
    lost = ~keep.any(-1)
    assert lost.any() and not y.reshape(B * S, -1)[lost].any()


def test_positions_hand_worked():
    """Token-major ranks within each expert: expert 3 at flat 0, 2, 3 gets
    0, 1, 2; expert 1 at 1, 4 gets 0, 1; expert 0 at 5 gets 0."""
    flat = torch.tensor([3, 1, 3, 3, 1, 0])
    want = torch.tensor([0, 0, 1, 2, 1, 0])
    assert torch.equal(PMoE.positions(flat, 4), want)
    assert torch.equal(moe_positions(flat, 4), want)


@pytest.mark.parametrize("n,e", [(1, 1), (33, 3), (1025, 8), (4096, 128)])
def test_positions_on_cpu_equal_the_one_hot_formula(n, e):
    """The wrapper on CPU tensors against the reference's formula in numpy
    (``src/repro/models/moe.py``: the one-hot's cumsum over the flat axis,
    less one, where the one-hot is set)."""
    flat = np.random.default_rng(n + e).integers(0, e, n)
    onehot = (flat[:, None] == np.arange(e)).astype(np.int64)
    want = ((np.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    got = moe_positions(torch.from_numpy(flat), e)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def test_positions_on_meta_tensors_are_int64_of_the_same_length():
    """The dry run's meta path: no data, the plain version's shape and dtype."""
    got = moe_positions(torch.empty(4096 * 8, dtype=torch.long, device="meta"), 128)
    assert got.device.type == "meta" and got.dtype == torch.int64 and got.shape == (4096 * 8,)


def test_positions_refuse_what_the_kernel_does_not_take():
    """The same refusals on the CPU as on the card: int32 ids, a strided or
    2-D view, expert counts outside [1, MAX_EXPERTS], and a DTensor (every
    caller passes its local ids)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.moe_positions import kernel as PK
    from repro_torch.launch.dryrun import fake_world

    flat = torch.arange(64) % 8
    with pytest.raises(TypeError):
        moe_positions(flat.to(torch.int32), 8)
    for bad in (flat[::2], flat.reshape(8, 8)):
        with pytest.raises(ValueError):
            moe_positions(bad, 8)
    for e in (0, PK.MAX_EXPERTS + 1):
        with pytest.raises(ValueError):
            moe_positions(flat, e)
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1,))
        with pytest.raises(TypeError):
            moe_positions(DTensor.from_local(flat, mesh, [Replicate()], run_check=False), 8)


def test_record_routing_nests_and_ends():
    cfg, ref_cfg = configs("qwen3-moe-235b-a22b")
    _, _, pt, xt = layer_inputs(ref_cfg, "f32", seed=0)
    with PMoE.record_routing() as outer:
        PMoE.moe_apply(pt, xt, cfg)
        with PMoE.record_routing() as inner:
            PMoE.moe_apply(pt, xt, cfg)
        PMoE.moe_apply(pt, xt, cfg)
    PMoE.moe_apply(pt, xt, cfg)
    assert len(outer) == 2 and len(inner) == 1 and PMoE._RECORD is None
    assert outer[0]["expert_idx"].shape == (B * S, cfg.top_k)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", MOE)
def test_forward_hidden_aux_under_remat(name, remat):
    """The aux loss is an output of each checkpointed cycle: equal to the
    run without remat, and its gradient reaches the routers."""
    cfg, _, _, model = reference_params(name, seed=3)
    model.requires_grad_(True)
    _, pb = batches(cfg, seed=3)
    got = {}
    for r in ("none", remat):
        hidden, aux = PM.forward_hidden(model, cfg, pb, PM.RunFlags(attn_impl="full", remat=r),
                                        torch.float32)
        grads = torch.autograd.grad(aux, list(model.parameters()), allow_unused=True)
        got[r] = hidden.detach(), aux.detach(), grads
    (h0, a0, g0), (h1, a1, g1) = got["none"], got[remat]
    assert torch.equal(h0, h1) and torch.equal(a0, a1) and float(a0) > 0
    routers = [i for i, (n, _) in enumerate(model.named_parameters()) if n.endswith("router")]
    assert routers and all(g1[i] is not None and g1[i].abs().max() > 0 for i in routers)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_aux_gradient_matches_jax():
    name = "qwen3-moe-235b-a22b"
    cfg, ref_cfg, tree, model = reference_params(name, seed=4)
    rb, pb = batches(cfg, seed=4)
    rflags = RM.RunFlags(attn_impl="full")
    with reference_routing() as ref_calls:
        RM.forward_hidden(tree, ref_cfg, rb, rflags, jnp.float32)
    ref_grad = jax.grad(lambda p: RM.forward_hidden(p, ref_cfg, rb, rflags, jnp.float32)[1])(tree)
    want = dict(params_from_reference(jax.tree.map(np.asarray, ref_grad), device="cpu")
                .named_parameters())
    model.requires_grad_(True)
    with PMoE.record_routing() as calls:
        _, aux = PM.forward_hidden(model, cfg, pb, PM.RunFlags(attn_impl="full"), torch.float32)
    same_routing(calls, ref_calls)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(aux, [t for _, t in named], allow_unused=True)
    assert set(want) == {n for n, _ in named}
    for (n, _), g in zip(named, grads):
        g = torch.zeros_like(want[n]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[n].detach().numpy(), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=n)


@pytest.mark.parametrize("name", MOE)
def test_moe_impl_shard_map_is_the_dense_path(name):
    cfg, _, _, model = reference_params(name, seed=5)
    _, pb = batches(cfg, seed=5)
    out = {}
    for impl in ("dense", "shard_map"):
        flags = PM.RunFlags(attn_impl="full", moe_impl=impl)
        logits, aux, _ = PM.forward(model, cfg, pb, flags, torch.float32)
        cache = PM.init_cache(cfg, B, 4, torch.float32, device="cpu")
        step, _ = PM.decode_step(model, cfg, cache, {"tokens": pb["tokens"][:, :1]}, 0, flags,
                                 torch.float32)
        out[impl] = logits, aux, step
    for a, b in zip(out["dense"], out["shard_map"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="moe_impl"):
        PM.forward(model, cfg, pb, PM.RunFlags(attn_impl="full", moe_impl="megablocks"),
                   torch.float32)


@pytest.mark.parametrize("name", MOE)
def test_params_from_reference_carries_moe_leaves(name):
    """bf16 experts keep their bits, the router stays f32, and
    ``cast_params`` leaves the router as it is."""
    cfg, ref_cfg, tree, model = reference_params(name, seed=6, dtype=jnp.bfloat16)
    t = model.tree()
    n_moe = 0
    for j, layer in enumerate(t["layers"]):
        pos, cyc = j % cfg.cycle_len, j // cfg.cycle_len
        if cfg.mlp_kind_at(pos) != "moe":
            continue
        n_moe += 1
        want = tree["layers"][pos]["mlp"]
        assert set(layer["mlp"]) == set(want) == {"router", "wi_gate", "wi_up", "wo"}
        assert layer["mlp"]["router"].dtype == torch.float32
        np.testing.assert_array_equal(layer["mlp"]["router"].numpy(), np.asarray(want["router"][cyc]))
        for key in ("wi_gate", "wi_up", "wo"):
            got = layer["mlp"][key]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(want[key][cyc]).view(np.int16))
    assert n_moe == sum(cfg.mlp_kind_at(j % cfg.cycle_len) == "moe" for j in range(cfg.n_layers))
    cast = PM.cast_params(model, torch.bfloat16)
    first = next(j for j in range(cfg.n_layers) if cfg.mlp_kind_at(j % cfg.cycle_len) == "moe")
    assert cast["layers"][first]["mlp"]["router"] is t["layers"][first]["mlp"]["router"]


@pytest.mark.parametrize("name", MOE)
def test_init_params_moe_layers(name):
    cfg = dataclasses.replace(reduced_config(name), n_layers=2 * reduced_config(name).cycle_len)
    ref_cfg = dataclasses.replace(ref_reduced(name), n_layers=cfg.n_layers)
    ref = jax.tree.map(np.asarray, RM.init_params(ref_cfg, jax.random.PRNGKey(0)))
    a = PM.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu").tree()
    b = PM.init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu").tree()
    pos = next(p for p in range(cfg.cycle_len) if cfg.mlp_kind_at(p) == "moe")
    mlp, rmlp = a["layers"][pos]["mlp"], ref["layers"][pos]["mlp"]
    assert set(a["layers"][pos]) == set(ref["layers"][pos])
    assert mlp["router"].dtype == torch.float32
    for key in ("router", "wi_gate", "wi_up", "wo"):
        assert tuple(mlp[key].shape) == rmlp[key].shape[1:]
        assert torch.equal(mlp[key], b["layers"][pos]["mlp"][key])  # seeded
        want = float(rmlp[key].astype(np.float32).std())
        assert abs(float(mlp[key].float().std()) - want) < 0.25 * want, key
    assert all(t.dtype == torch.bfloat16 for k, t in mlp.items() if k != "router")
    assert float(a["layers"][pos]["norm2"].abs().max()) == 0.0
