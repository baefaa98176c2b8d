"""``runtime.trace``: the port's spans and counters, on the CPU.

- Off (no recording) ``span`` is one shared no-op: it and
  ``count`` dispatch no op, and the MoE layer dispatches exactly its own
  ops; a recording holds only what ran inside it.
- Parents, roots and self time on a synthetic nest with a stepped clock,
  worked out by hand.
- The train step (two microbatches, remat none and full) and a Qwen3-MoE
  prefill under a recording: the spans the call sites promise, and the
  same losses, parameters and logits bit for bit as without one; the
  ``moe/kept`` counter equals the kept assignments ``record_routing``
  reports.
- A profiler gets no ``repro/*`` range, with a recording open or not.
"""
import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import reduced_config
from repro_torch.launch.serve import generate
from repro_torch.models import moe
from repro_torch.models.model import RunFlags, init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import trace
from repro_torch.train.step import init_train_state, make_train_step

FLAGS = RunFlags(attn_impl="kernel", norm_impl="kernel")


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


class Clock:
    """``time.perf_counter_ns`` stepped by hand, in ms."""

    def __init__(self):
        self.ms = 0

    def perf_counter_ns(self):
        return int(self.ms * 1e6)


def test_off_span_is_one_shared_no_op():
    assert not trace.counting()
    assert trace.span("a") is trace.span("b")
    with OpLog() as log:
        with trace.span("train/step"):
            trace.count("moe/kept", torch.ones(()).sum())  # the sum is the test's op
            trace.count("moe/rows", 3)
    assert log.ops == ["ones", "sum"]
    with trace.recording() as r:
        pass
    assert r.summary() == {"spans": {}, "roots": [], "counters": {}}


def test_a_recording_holds_only_what_ran_inside_it():
    with trace.span("outer"):
        with trace.recording() as r:
            with trace.span("inner"):
                pass
    s = r.summary()
    assert list(s["spans"]) == ["inner"] and [x["name"] for x in s["roots"]] == ["inner"]
    with pytest.raises(RuntimeError):
        with trace.recording(), trace.recording():
            pass
    assert not trace.counting()


def test_nesting_parents_roots_and_self_time(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(trace, "time", clock)
    with trace.recording() as r:
        with trace.span("a"):            # a: 0 - 30
            clock.ms += 10
            with trace.span("b"):        # b: 10 - 15
                clock.ms += 5
            clock.ms += 3
            with trace.span("b"):        # b: 18 - 28, its child c 20 - 24
                clock.ms += 2
                with trace.span("c"):
                    clock.ms += 4
                    trace.count("n", 2)
                clock.ms += 4
            clock.ms += 2
        clock.ms += 1
        with trace.span("d"):            # d: 31 - 38, a second root
            clock.ms += 7
            trace.count("n", 5)
    assert [(x["name"], x["parent"], x["root"]) for x in r.spans] == [
        ("a", None, 0), ("b", 0, 0), ("b", 0, 0), ("c", 2, 0), ("d", None, 4)]
    assert r.spans[3]["host"] == (20.0, 24.0)
    s = r.summary()
    assert s["counters"] == {"n": 7}
    a, b, c, d = (s["spans"][k] for k in "abcd")
    assert (a["n"], a["host_ms"], a["host_self_ms"]) == (1, 30.0, 15.0)
    assert (b["n"], b["host_ms"], b["host_self_ms"]) == (2, 15.0, 11.0)
    assert (c["host_ms"], c["host_self_ms"], d["host_ms"], d["host_self_ms"]) == (4.0, 4.0, 7.0, 7.0)
    assert a["device_ms"] is None and a["device_self_ms"] is None  # no CUDA here
    assert [x["name"] for x in s["roots"]] == ["a", "d"]
    first = s["roots"][0]["spans"]
    assert set(first) == {"a", "b", "c"} and first["b"]["host_ms"] == 15.0
    assert s["roots"][1]["spans"] == {"d": d}


def test_self_time_counts_overlapping_children_once():
    assert trace._covered([(2.0, 6.0), (4.0, 8.0), (9.0, 20.0)], 0.0, 10.0) == 7.0
    assert trace._covered([], 0.0, 10.0) == 0.0


def _steps(remat: str, record: bool):
    cfg = dataclasses.replace(reduced_config("qwen3-1.7b"), n_layers=2)
    state = init_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, dataclasses.replace(FLAGS, remat=remat), AdamWConfig(warmup_steps=1),
                           microbatches=2)
    g = torch.Generator().manual_seed(3)
    losses, summaries = [], []
    for _ in range(2):
        t = torch.randint(0, cfg.vocab_size, (4, 17), generator=g)
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if record:
            with trace.recording() as r:
                state, m = step(state, batch)
            summaries.append(r.summary())
        else:
            state, m = step(state, batch)
        losses.append(m["loss"])
    return losses, state, summaries


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_spans_and_bits(remat):
    plain_losses, plain, _ = _steps(remat, False)
    losses, state, summaries = _steps(remat, True)
    assert all(torch.equal(a, b) for a, b in zip(losses, plain_losses))
    for (name, p), q in zip(state["params"].named_parameters(), plain["params"].parameters()):
        assert torch.equal(p, q), name
    assert all(torch.equal(a, b) for a, b in zip(state["opt"]["m"].values(), plain["opt"]["m"].values()))
    for s in summaries:
        assert {k: v["n"] for k, v in s["spans"].items()} == {
            "train/step": 1, "train/forward": 2, "train/backward": 2, "train/optimizer": 1}
        assert [r["name"] for r in s["roots"]] == ["train/step"]
        step = s["spans"]["train/step"]
        inner = sum(s["spans"][k]["host_ms"] for k in ("train/forward", "train/backward", "train/optimizer"))
        assert step["host_self_ms"] == pytest.approx(step["host_ms"] - inner)
        assert 0 <= step["host_self_ms"] < step["host_ms"]


def _moe_prefill(record: bool):
    cfg = dataclasses.replace(reduced_config("qwen3-moe-235b-a22b"), n_layers=2)
    m = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(5))}
    if not record:
        return cfg, generate(m, cfg, prompt, 0, flags=FLAGS)[1], None, None
    with trace.recording() as r, moe.record_routing() as calls:
        _, logits = generate(m, cfg, prompt, 0, flags=FLAGS)
    return cfg, logits, r.summary(), calls


def test_moe_prefill_spans_counters_and_bits():
    cfg, plain, _, _ = _moe_prefill(False)
    _, logits, s, calls = _moe_prefill(True)
    assert torch.equal(logits, plain)
    n_moe = cfg.n_layers  # every layer of the reduced stack is a MoE layer
    assert {k: v["n"] for k, v in s["spans"].items()} == {
        "serve/prefill": 1, "moe/dispatch": n_moe, "moe/experts": n_moe, "moe/combine": n_moe}
    assert [r["name"] for r in s["roots"]] == ["serve/prefill"]
    assert len(calls) == n_moe
    kept = sum(int(c["keep"].sum()) for c in calls)
    rows = n_moe * cfg.n_experts * moe.capacity(2 * 16, cfg)
    assert s["counters"] == {"moe/rows": rows, "moe/kept": kept}
    assert 0 < kept <= 2 * 16 * cfg.top_k * n_moe < rows


def test_moe_layer_dispatches_only_its_own_ops_when_off():
    """Off, the instrumented layer dispatches what it dispatches inside a
    recording less the ``moe/kept`` counter's sum (and the detach that
    keeps it): the spans add no op."""
    cfg = reduced_config("qwen3-moe-235b-a22b")
    params = init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    mlp = dict(params.named_parameters())
    layer = {k.rsplit(".", 1)[-1]: v.detach() for k, v in mlp.items() if ".mlp." in k}
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(2))
    with OpLog() as off:
        y_off, _ = moe.moe_apply(layer, x, cfg)
    with trace.recording() as r, OpLog() as on:
        y_on, _ = moe.moe_apply(layer, x, cfg)
    assert torch.equal(y_on, y_off)
    extra = collections.Counter(on.ops) - collections.Counter(off.ops)
    assert not collections.Counter(off.ops) - collections.Counter(on.ops)
    assert extra["sum"] == 1 and set(extra) <= {"sum", "detach"}
    assert r.summary()["counters"]["moe/rows"] == cfg.n_experts * moe.capacity(16, cfg)


def test_a_profiler_sees_no_repro_range():
    """The spans open no profiler range, with or without a recording (a
    range's device-side shadow would read as device work); the recording
    under a profiler still holds every span."""
    cfg = dataclasses.replace(reduced_config("qwen3-moe-235b-a22b"), n_layers=1)
    m = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 8))}
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu) as alone:
        assert trace.span("x") is trace.span("y")
        generate(m, cfg, prompt, 0, flags=FLAGS)
    with torch.profiler.profile(activities=cpu) as prof, trace.recording() as r:
        generate(m, cfg, prompt, 0, flags=FLAGS)
    for p in (alone, prof):
        assert not [e.name for e in p.events() if e.name.startswith("repro/")]
    spans = r.summary()["spans"]
    assert {name: spans[name]["n"] for name in ("serve/prefill", "moe/dispatch", "moe/experts", "moe/combine")} \
        == {"serve/prefill": 1, "moe/dispatch": 1, "moe/experts": 1, "moe/combine": 1}
