"""The port's analysis gate on the card: ``run_all(device="cuda")`` is clean,
the chain block's audit sees its K phase-sim launches and the kernel's
symbol, an ``.item()`` injected into the chain step is caught by both the
op log and sync-debug, and a wrapper forced onto the plain version fails the
required-kernel check. Every test here needs a CUDA device: each carries the
``gpu`` marker and skips where there is none.

This file imports only the port (no JAX, no JAX package), so it runs on a
machine that has PyTorch with CUDA and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_analysis.py
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase-sim kernel has no CPU mode")
    return torch.device("cuda")


def _rules(findings):
    return {f.rule for f in findings if f.live}


def test_run_all_is_clean_on_the_card(cuda):
    from repro_torch.analysis import run_all

    report = {}
    findings = run_all(device="cuda", report=report)
    live = [f for f in findings if f.live]
    assert not live, "\n".join(f.render() for f in live)
    assert report["bucket_grid"]["bucket"] == report["bucket_grid"]["buffer_key"] == 100
    assert report["ops.phase_sim"]["launches"] == 1
    assert report["ops.phase_sim"]["kernel_events"] >= 1
    for entry in ("phase_sim_plain", "chain_block", "ops.phase_sim"):
        assert report[entry]["forbidden"] == 0, report[entry]


def test_chain_block_audit_sees_k_launches_and_the_symbol(cuda):
    from repro_torch.analysis.launch_audit import CHAIN_K, run_launch_audit

    report = {}
    findings = run_launch_audit("cuda", entries=["chain_block"], report=report)
    assert not findings, "\n".join(f.render() for f in findings)
    block = report["chain_block"]
    assert block["launches"] == CHAIN_K
    assert block["kernel_events"] == CHAIN_K
    assert block["window_syncs"] == 0 and block["window_dtoh"] == 0
    assert block["window_runtime_calls"] > 0  # the window's check is not vacuous
    assert block["casts"] > 0  # dtype casts are dispatched, and allowed


def test_injected_item_is_caught_by_op_log_and_sync_debug(cuda, monkeypatch):
    from repro_torch.analysis.launch_audit import run_launch_audit
    from repro_torch.core import device_explore as dx

    class LeakyBlock(dx._ChainBlock):
        def _step(self, c, *args):
            c.fitness.sum().item()  # the host sync under test
            return super()._step(c, *args)

    monkeypatch.setattr(dx, "_ChainBlock", LeakyBlock)
    findings = run_launch_audit("cuda", entries=["chain_block"])
    rules = _rules(findings)
    # the op log and sync-debug in the audited block; the profiled block's
    # window shows the .item()'s copy and synchronisation
    assert {"forbidden-op", "sync-debug", "window"} <= rules, rules
    assert any("_local_scalar_dense" in f.message for f in findings)


def test_wrapper_forced_onto_the_plain_version_fails_required_kernel(cuda, monkeypatch):
    from repro_torch.analysis.launch_audit import run_launch_audit
    from repro_torch.kernels.phase_sim import ops

    real = ops.phase_sim_rows

    def plain_on_host(enc, rows, **kw):
        packed = real(enc, {k: v.cpu() for k, v in rows.items()})
        return packed.to(rows["task_pe"].device)

    monkeypatch.setattr(ops, "phase_sim_rows", plain_on_host)
    findings = run_launch_audit("cuda", entries=["wrapper"])
    assert "required-kernel" in _rules(findings), [f.render() for f in findings]
    assert any("moved phase_sim_cuda.launches by 0" in f.message for f in findings)
