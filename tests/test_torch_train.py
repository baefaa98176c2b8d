"""The port's training step against the JAX package's, on the CPU, on the
reduced Qwen3-1.7B config two layers deep, with the reference's initial
state carried across by ``convert.train_state_from_reference``.

- f32 gradients of ``forward_hidden`` + ``chunked_ce_loss`` against
  ``jax.value_and_grad`` of the reference's: each parameter's gradient
  within 1e-5 of its own max |value| (measured worst 2.4e-6: the same f32
  arithmetic in another summation order), under ``attn_impl`` "full",
  "blockwise" with blocks smaller than S (the flash backward runs), and
  the port's "kernel" path (its Functions' plain versions on the CPU, held
  to the reference's "full").
- The bf16 ``make_train_step`` against the jitted reference's at
  microbatches 1 and 2: loss and grad norm within rtol 2e-2 (bf16
  rounding), the learning rate within 1e-7, and parameters, m and v within
  2.5 × lr: a first AdamW step moves each weight by about lr (1 + wd), so a
  gradient whose sign bf16 rounding flips costs about 2 lr.
- ``remat`` "full" and "dots" equal "none" bit for bit (recomputation
  repeats the same CPU arithmetic).
- ``optim.adamw`` and ``optim.compress`` against the reference on random
  trees: int8 payloads exact, everything else within 1e-7 relative to each
  leaf's max |value|, with two stated exceptions. The grad norm's sums of
  squares run in another order than XLA's: within 5e-7 relative (measured
  3.3e-7, a few f32 ulps). When clipping is active the clip scale carries
  that difference into every moment, and an EMA that nearly cancels makes
  a small entry's relative error large: there params, m and v are held
  within 1e-6 of the tree's max |value| (measured 6.0e-7); with clipping
  inactive they agree to 1e-7 (measured: m and v bit for bit).
- ``data.pipeline``: the same batches as the reference's for several
  steps, host shards and embeddings mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import reduced_config as ref_reduced  # noqa: E402
from repro.data import pipeline as RD  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.optim import compress as RC  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch.configs.registry import reduced_config  # noqa: E402
from repro_torch.data import pipeline as PD  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.models.convert import params_from_reference, train_state_from_reference  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.optim import compress as PC  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402

GRAD_TOL = 1e-5
LOSS_RTOL, LR_ATOL, PARAM_LRS = 2e-2, 1e-7, 2.5
OPT_TOL, GNORM_TOL, CLIPPED_TOL = 1e-7, 5e-7, 1e-6
LR = 1e-3
S, BATCH = 32, 4


def configs(name="qwen3-1.7b"):
    ref_cfg = dataclasses.replace(ref_reduced(name), n_layers=2)
    cfg = dataclasses.replace(reduced_config(name), n_layers=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return cfg, ref_cfg


def by_name(tree) -> dict:
    """A reference tree (numpy leaves) as the port's {parameter name: tensor}."""
    return {n: p.detach() for n, p in params_from_reference(tree, device="cpu").named_parameters()}


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30)).item()


@pytest.fixture(scope="module")
def reference_state():
    cfg, ref_cfg = configs()
    state = RS.init_train_state(ref_cfg, jax.random.PRNGKey(0))
    return cfg, ref_cfg, state, jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("attn_impl,norm_impl", [("full", "reference"), ("blockwise", "reference"),
                                                 ("kernel", "kernel")])
def test_f32_gradients_match_reference(reference_state, attn_impl, norm_impl):
    cfg, ref_cfg, state, np_state = reference_state
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    rflags = RM.RunFlags(attn_impl="full" if attn_impl == "kernel" else attn_impl, q_block=8, kv_block=16)

    def ref_loss(p):
        h, _ = RM.forward_hidden(p, ref_cfg, {"tokens": jnp.asarray(toks)}, rflags, compute_dtype=jnp.float32)
        return RS.chunked_ce_loss(h, RM.head_matrix(p, ref_cfg, jnp.float32), jnp.asarray(labels))

    want_loss, want = jax.value_and_grad(ref_loss)(state["params"])
    model = params_from_reference(np_state["params"], device="cpu").requires_grad_(True)
    flags = PM.RunFlags(attn_impl=attn_impl, norm_impl=norm_impl, q_block=8, kv_block=16)
    hidden, aux = PM.forward_hidden(model, cfg, {"tokens": torch.from_numpy(toks).long()}, flags,
                                    compute_dtype=torch.float32)
    loss = PS.chunked_ce_loss(hidden, PM.head_matrix(model, cfg, torch.float32), torch.from_numpy(labels))
    assert float(aux) == 0.0
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    want = by_name(jax.tree.map(np.asarray, want))
    assert abs(loss.item() - float(want_loss)) <= GRAD_TOL * abs(float(want_loss))
    assert sorted(names) == sorted(want)
    for n, g in zip(names, grads):
        assert rel(g, want[n]) <= GRAD_TOL, (n, rel(g, want[n]))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_bf16_train_step_matches_reference(reference_state, microbatches):
    cfg, ref_cfg, state, np_state = reference_state
    batch = RD.for_model(ref_cfg, seq_len=S, global_batch=BATCH, seed=1).next_batch()
    ref_opt = RA.AdamWConfig(peak_lr=LR, warmup_steps=0, total_steps=10)
    opt = PA.AdamWConfig(peak_lr=LR, warmup_steps=0, total_steps=10)
    ref_step = jax.jit(RS.make_train_step(ref_cfg, RM.RunFlags(attn_impl="full"), ref_opt, microbatches))
    want_state, want = ref_step(state, jax.tree.map(jnp.asarray, batch))
    got_state, got = PS.make_train_step(cfg, PM.RunFlags(attn_impl="full"), opt, microbatches)(
        train_state_from_reference(np_state, device="cpu"), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(got[key]) - float(want[key])) <= LOSS_RTOL * abs(float(want[key])), key
    assert abs(float(got["lr"]) - float(want["lr"])) <= LR_ATOL
    assert float(got["aux_loss"]) == 0.0 and int(got_state["step"]) == int(want_state["step"]) == 1
    assert int(got_state["opt"]["count"]) == 1
    want_np = jax.tree.map(np.asarray, want_state)
    bar = PARAM_LRS * LR
    for label, got_tree, want_tree in (
            ("params", {n: p.detach() for n, p in got_state["params"].named_parameters()}, want_np["params"]),
            ("m", got_state["opt"]["m"], want_np["opt"]["m"]), ("v", got_state["opt"]["v"], want_np["opt"]["v"])):
        want_tree = by_name(want_tree)
        for n, t in got_tree.items():
            assert (t - want_tree[n]).abs().max().item() <= bar, (label, n)


def test_train_step_updates_the_state_in_place_and_learns():
    cfg, _ = configs()
    state = PS.init_train_state(cfg, seed=0, device="cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    first = state["params"].final_norm
    before = first.detach().clone()
    data = PD.for_model(cfg, seq_len=S, global_batch=8, seed=0)
    step = PS.make_train_step(cfg, PM.RunFlags(attn_impl="kernel", norm_impl="kernel"),
                              PA.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=30))
    losses = []
    for _ in range(12):
        state, m = step(state, data.next_batch())
        losses.append(float(m["loss"]))
    assert state["params"].final_norm is first and not torch.equal(first.detach(), before)
    assert int(state["step"]) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_no_remat_bitwise(remat):
    cfg, _ = configs()
    batch = PD.for_model(cfg, seq_len=S, global_batch=BATCH, seed=2).next_batch()
    opt = PA.AdamWConfig(peak_lr=LR, warmup_steps=0, total_steps=10)
    out = {}
    for r in ("none", remat):
        flags = PM.RunFlags(attn_impl="kernel", norm_impl="kernel", q_block=8, kv_block=16, remat=r)
        state, m = PS.make_train_step(cfg, flags, opt)(PS.init_train_state(cfg, seed=3, device="cpu"), batch)
        out[r] = (m, {n: p.detach() for n, p in state["params"].named_parameters()}, state["opt"])
    (m0, p0, o0), (m1, p1, o1) = out["none"], out[remat]
    assert all(torch.equal(m0[k], m1[k]) for k in ("loss", "grad_norm"))
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert all(torch.equal(o0["m"][n], o1["m"][n]) and torch.equal(o0["v"][n], o1["v"][n]) for n in p0)


def test_remat_rejects_an_unknown_policy():
    cfg, _ = configs()
    state = PS.init_train_state(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="remat"):
        PM.forward_hidden(state["params"], cfg, batch, PM.RunFlags(remat="everything"))


def test_chunked_ce_matches_cross_entropy():
    g = torch.Generator().manual_seed(3)
    hidden = torch.randn(2, 32, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 64, generator=g)
    labels = torch.randint(0, 64, (2, 32), generator=g)
    plain = PS.cross_entropy(hidden @ w, labels)
    chunked = PS.chunked_ce_loss(hidden, w, labels, n_chunks=4)
    torch.testing.assert_close(chunked, plain, rtol=1e-6, atol=0)
    g1 = torch.autograd.grad(plain, hidden)[0]
    g2 = torch.autograd.grad(chunked, hidden)[0]
    torch.testing.assert_close(g2, g1, atol=1e-6, rtol=1e-4)
    ref = RS.cross_entropy(jnp.asarray((hidden @ w).detach().numpy()), jnp.asarray(labels.numpy()))
    assert abs(float(ref) - plain.item()) <= 1e-6 * abs(float(ref))


# ---------------------------------------------------------------------------
# optimizer and compression on random trees
# ---------------------------------------------------------------------------
SHAPES = {"a": (3, 4), "b": (17,), "c": (5, 6, 7), "d": (1,)}


def test_schedule_matches_reference():
    for cfg_kw in (dict(warmup_steps=3, total_steps=10), dict(warmup_steps=0, total_steps=5),
                   dict(warmup_steps=100, total_steps=10_000, peak_lr=3e-4)):
        ref, port = RA.AdamWConfig(**cfg_kw), PA.AdamWConfig(**cfg_kw)
        for step in (0, 1, 2, 3, 5, 9, 10, 11, 100, 5000, 20000):
            want = float(RA.schedule(jnp.int32(step), ref))
            got = PA.schedule(torch.tensor(step, dtype=torch.int32), port)
            assert got.dtype == torch.float32 and abs(got.item() - want) <= OPT_TOL * max(abs(want), 1e-30)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("clip_norm", [1.0, 1e4])  # clipping active, inactive
def test_adamw_update_matches_reference(seed, clip_norm):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    ref_cfg = RA.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip_norm)
    cfg = PA.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip_norm)
    rp, rs = {k: jnp.asarray(v) for k, v in p.items()}, RA.init(p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = PA.init(tp)
    for _ in range(5):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in SHAPES.items()}
        rp, rs, rm = RA.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp, ref_cfg)
        tp2, ts, tm = PA.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, cfg)
        assert tp2 is tp  # updated in place
        assert abs(tm["lr"].item() - float(rm["lr"])) <= OPT_TOL * float(rm["lr"])
        assert abs(tm["grad_norm"].item() - float(rm["grad_norm"])) <= GNORM_TOL * float(rm["grad_norm"])
        assert int(ts["count"]) == int(rs["count"])
        for got, want in ((tp, rp), (ts["m"], rs["m"]), (ts["v"], rs["v"])):
            want = {k: torch.from_numpy(np.array(w)) for k, w in want.items()}
            if float(rm["grad_norm"]) <= clip_norm:  # scale 1: the same f32 ops on the same values
                assert all(rel(got[k], want[k]) <= OPT_TOL for k in SHAPES)
            else:
                top = max(w.abs().max().item() for w in want.values())
                assert all((got[k] - want[k]).abs().max().item() <= CLIPPED_TOL * top for k in SHAPES)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    want = float(RA.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = PA.global_norm({k: torch.from_numpy(v) for k, v in tree.items()}).item()
    assert abs(got - want) <= GNORM_TOL * want


@torch.no_grad()
def whole_tree_update(grads, state, params, cfg):
    """The update as one ``_foreach`` sequence over the whole tree (the
    optimizer's form before it grouped leaves): the oracle of the grouped
    update."""
    count = state["count"] + 1
    lr = PA.schedule(count, cfg)
    gnorm = PA.global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    names = list(params)
    g = [grads[k].to(torch.float32) for k in names]
    torch._foreach_mul_(g, scale)
    m = [state["m"][k] for k in names]
    v = [state["v"][k] for k in names]
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - cfg.b2), g))
    cnt = count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** cnt
    bc2 = 1 - cfg.b2 ** cnt
    p = [params[k] for k in names]
    denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(denom, cfg.eps)
    step = torch._foreach_div(torch._foreach_div(m, bc1), denom)
    pf = [x.to(torch.float32) for x in p]
    torch._foreach_add_(step, torch._foreach_mul(pf, cfg.weight_decay))
    torch._foreach_mul_(step, lr)
    new = torch._foreach_sub(pf, step)
    for x, y in zip(p, new):
        x.copy_(y)
    state["count"] = count
    return params, state, {"lr": lr, "grad_norm": gnorm}


GROUP_SHAPES = {"a": (3, 4), "big": (40, 50), "b": (17,), "c": (5, 6, 7), "d": (1,), "h": (8, 3)}


@pytest.mark.parametrize("group_bytes", [1, 200, 1000, PA.GROUP_BYTES])
@pytest.mark.parametrize("clip_norm", [1.0, 1e4])  # clipping active, inactive
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_update_equals_whole_tree_update_bitwise(monkeypatch, group_bytes, clip_norm, dtype):
    """The grouped update against the whole-tree one, five steps from the
    same random tree: params, m, v, lr and grad norm bit for bit. At 1 byte
    every leaf is a group alone; at 200 and 1000 bytes groups hold several
    leaves, and "big" (8,000 bytes) is larger than a group."""
    rng = np.random.default_rng(7)
    base = {k: rng.standard_normal(s).astype(np.float32) for k, s in GROUP_SHAPES.items()}
    cfg = PA.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip_norm)
    trees = [{k: torch.from_numpy(v.copy()).to(dtype) for k, v in base.items()} for _ in range(2)]
    states = [PA.init(t) for t in trees]
    monkeypatch.setattr(PA, "GROUP_BYTES", group_bytes)
    cut = PA.groups(trees[0], group_bytes)
    assert [k for grp in cut for k in grp] == list(GROUP_SHAPES)
    assert ["big"] in cut or group_bytes == PA.GROUP_BYTES
    assert (len(cut) == len(GROUP_SHAPES)) == (group_bytes == 1)
    clipped = []
    for _ in range(5):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in GROUP_SHAPES.items()}
        _, _, got = PA.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, states[0], trees[0], cfg)
        _, _, want = whole_tree_update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, states[1],
                                       trees[1], cfg)
        clipped.append(float(want["grad_norm"]) > clip_norm)
        assert torch.equal(got["lr"], want["lr"]) and torch.equal(got["grad_norm"], want["grad_norm"])
        for k in GROUP_SHAPES:
            assert trees[0][k].dtype == dtype and torch.equal(trees[0][k], trees[1][k]), k
            assert torch.equal(states[0]["m"][k], states[1]["m"][k]), k
            assert torch.equal(states[0]["v"][k], states[1]["v"][k]), k
    assert all(clipped) if clip_norm == 1.0 else not any(clipped)


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_matches_reference(seed):
    rng = np.random.default_rng(seed)
    err = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    ref_err = {k: jnp.asarray(v) for k, v in err.items()}
    port_err = PC.init_error({k: torch.from_numpy(v) for k, v in err.items()})
    for _ in range(3):  # the error feedback carries over
        g = {k: (rng.standard_normal(s) * 2).astype(np.float32) for k, s in SHAPES.items()}
        rq, ref_err = RC.compress_with_feedback({k: jnp.asarray(v) for k, v in g.items()}, ref_err)
        pq, port_err = PC.compress_with_feedback({k: torch.from_numpy(v) for k, v in g.items()}, port_err)
        want_d, got_d = RC.decompress(rq), PC.decompress(pq)
        for k in SHAPES:
            assert pq.payload[k].dtype == torch.int8
            assert np.array_equal(pq.payload[k].numpy(), np.asarray(rq.payload[k]))
            assert abs(pq.scale[k].item() - float(rq.scale[k])) <= OPT_TOL * float(rq.scale[k])
            assert rel(port_err[k], torch.from_numpy(np.array(ref_err[k]))) <= OPT_TOL
            assert rel(got_d[k], torch.from_numpy(np.array(want_d[k]))) <= OPT_TOL


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(vocab_size=512, seq_len=16, global_batch=4, seed=7),
                                dict(vocab_size=151936, seq_len=64, global_batch=2, seed=0),
                                dict(vocab_size=64, seq_len=8, global_batch=8, seed=1, n_hosts=4,
                                     host_index=2),
                                dict(vocab_size=64, seq_len=8, global_batch=4, seed=3,
                                     input_mode="embeddings", d_model=16)])
def test_synthetic_lm_matches_reference(kw):
    ref, port = RD.SyntheticLM(RD.DataConfig(**kw)), PD.SyntheticLM(PD.DataConfig(**kw))
    for _ in range(4):
        a, b = ref.next_batch(), port.next_batch()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert port.state_dict() == ref.state_dict()
    port.skip_to(1)
    ref.skip_to(1)
    assert all(np.array_equal(x, y) for x, y in zip(ref.next_batch().values(), port.next_batch().values()))


def test_for_model_matches_reference():
    cfg, ref_cfg = configs()
    a = RD.for_model(ref_cfg, seq_len=16, global_batch=4, seed=5).next_batch()
    b = PD.for_model(cfg, seq_len=16, global_batch=4, seed=5).next_batch()
    assert all(np.array_equal(a[k], b[k]) for k in a) and sorted(a) == sorted(b)
