"""CPU tests of ``perfbench/spans.py`` and the metrics that read the
program's spans and counters: each metric goes to its one cell; a traced run
of each cell at a reduced size records once, at least ``MIN_UNITS`` units,
reads the training host times and the MoE row use, and leaves the device
times out (no CUDA events on the CPU); a program without ``runtime.trace``
gives no reading and no error; a recording without a reader's span
raises."""
import json
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness, spans, spec

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
TINY_MOE = dict(TINY, n_experts=4, top_k=2, moe_d_ff=64, d_ff=64)
TRAIN_HOST = {"step_host_ms.train", "forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train"}
MOE_DEVICE = {"moe_dispatch_ms.prefill", "moe_experts_ms.prefill", "moe_combine_ms.prefill"}
CASES = {"qwen3-1.7b.train-s4k": (TINY, dict(batch=2, seq_len=16, trace_seconds=0.2)),
         "qwen3-moe-4l.prefill-s4k": (TINY_MOE, dict(prompt_len=32, check_requests=2, trace_seconds=0.2))}


def test_each_metric_goes_to_its_one_cell():
    cells = {w["name"]: {m["name"] for m in spec.load(w["name"]).per_layer} for w in BENCH["workloads"]}
    assert TRAIN_HOST <= cells["qwen3-1.7b.train-s4k"]
    assert MOE_DEVICE | {"moe_row_use.prefill"} <= cells["qwen3-moe-4l.prefill-s4k"]
    for name in TRAIN_HOST | MOE_DEVICE | {"moe_row_use.prefill"}:
        assert sum(name in names for names in cells.values()) == 1, name
        assert callable(spec.load(next(c for c, n in cells.items() if name in n)).reader(name).read)


@pytest.mark.parametrize("workload", sorted(CASES))
def test_a_traced_run_records_one_window_and_reads_it(workload, monkeypatch, capsys):
    monkeypatch.setattr(spans, "RECORD_SECONDS", 0.2)
    driver_cls = spec.load(workload).driver().Driver
    real, tracers = driver_cls.window, []

    def window(self, seconds, tracer):
        tracers.append(tracer.on)
        return real(self, seconds, tracer)

    monkeypatch.setattr(driver_cls, "window", window)
    real_record, records = spans._record, []
    monkeypatch.setattr(spans, "_record", lambda run: records.append(1) or real_record(run))
    cfg, mix = CASES[workload]
    keep = {}
    result = harness.run_cell(workload, 2**35 + 9, 0.2, True, device="cpu", config_override=cfg,
                              mix_override=mix, keep=keep)
    assert tracers[:2] == [False, True] and not any(tracers[2:])  # measured, traced, recorded
    assert records == [1]  # once for every reader
    metrics = result["metrics"]
    assert not MOE_DEVICE & set(metrics)  # device times need CUDA events
    recorded = getattr(keep["driver"], "program_spans")
    assert len(recorded["roots"]) >= spans.MIN_UNITS
    if "train" in workload:
        assert TRAIN_HOST <= set(metrics) and "moe_row_use.prefill" not in metrics
        host = {k: metrics[k]["value"] for k in TRAIN_HOST}
        assert all(v > 0 for v in host.values()) and all(metrics[k]["unit"] == "ms" for k in TRAIN_HOST)
        parts = host["forward_host_ms.train"] + host["backward_host_ms.train"] + host["optimizer_host_ms.train"]
        assert parts < host["step_host_ms.train"]
        assert {r["name"] for r in recorded["roots"]} == {"train/step"}
    else:
        assert not TRAIN_HOST & set(metrics)
        use = metrics["moe_row_use.prefill"]
        assert use["unit"] == "%" and 0 < use["value"] <= 100.0 * 32 * 2 / (4 * 20)
        c = recorded["counters"]
        assert c["moe/rows"] == 4 * 20 * TINY_MOE["n_layers"] * len(recorded["roots"])  # E·C = 4 · 20 a layer
        assert {r["name"] for r in recorded["roots"]} == {"serve/prefill"}
    err = capsys.readouterr().err
    root = "train/step" if "train" in workload else "serve/prefill"
    assert "spans: recorded " in err and f"spans: {root} host_ms a unit: median " in err


def test_a_program_without_the_module_reads_nothing(monkeypatch):
    import repro_torch.runtime

    monkeypatch.delattr(repro_torch.runtime, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)  # its import raises ImportError
    for workload, (cfg, mix) in CASES.items():
        cell = spec.load(workload)
        cell.config.update(cfg)
        run = types.SimpleNamespace(cell=cell, cfg=cell.model_config(), driver=types.SimpleNamespace(),
                                    device=types.SimpleNamespace(type="cpu"))
        for m in cell.per_layer:
            if m["name"] in TRAIN_HOST | MOE_DEVICE | {"moe_row_use.prefill"}:
                assert cell.reader(m["name"]).read(run) is None
        assert run.driver.program_spans is None


def test_a_recorded_root_without_the_span_raises():
    """A renamed span fails the run instead of leaving its metric out."""
    cell = spec.load("qwen3-1.7b.train-s4k")
    step = {"n": 1, "host_ms": 5.0, "device_ms": None}
    roots = [{"name": "train/step", "spans": {"train/step": step, "train/forward": step}},
             {"name": "train/step", "spans": {"train/step": step}}]
    run = types.SimpleNamespace(cell=cell, driver=types.SimpleNamespace(program_spans={"roots": roots}))
    assert cell.reader("step_host_ms.train").read(run) == 5.0
    with pytest.raises(LookupError, match="1 of 2 recorded train/step spans hold no train/forward span"):
        cell.reader("forward_host_ms.train").read(run)
    with pytest.raises(LookupError, match="0 of 0 recorded train/step spans"):
        run.driver.program_spans = {"roots": []}
        cell.reader("step_host_ms.train").read(run)
