"""repro_torch.analysis — the port's static contract checker, torch lint,
and launch audit.

Three passes that make the repo's recurring desync bugs un-shippable in the
port (``python -m repro_torch.analysis --strict``, gated in tier-1 by
``tests/test_torch_analysis.py`` and on the card by ``chip_smoke.py``'s
``analysis`` phase):

* :mod:`~repro_torch.analysis.contracts` — cross-file layout contracts
  (the scal-column schema against the hand-written CUDA source,
  ChainCarry/MoveTable widths, MV_* dispatch coverage, the policy registry
  vs the docs).
* :mod:`~repro_torch.analysis.lint` — AST rules over ``src/repro_torch/``
  for host synchronisations inside declared hot scopes.
* :mod:`~repro_torch.analysis.launch_audit` — runs the hot entry points
  under an op log and asserts forbidden ops, the kernel's launches, and the
  buffer-key bound.

See ``docs/ANALYSIS_TORCH.md`` for the rule list, the ``# repro_torch:
hot`` marker, the ``# repro_torch: noqa[rule]: reason`` suppression format,
and the baseline workflow.

This package is import-light on purpose: importing it (or running
``--help``) pulls in neither torch nor jax — the passes import their
subjects lazily when they run.
"""
from .findings import Finding, format_findings

__all__ = [
    "PASSES",
    "DeviceUnavailable",
    "Finding",
    "format_findings",
    "run_all",
    "run_contracts",
    "run_lint",
    "run_launch_audit",
]

PASSES = ("contracts", "lint", "launch")


class DeviceUnavailable(RuntimeError):
    """The device asked for is not there (the audit never runs on another
    one instead)."""


def run_contracts(*args, **kwargs):
    from .contracts import run_contracts as _rc

    return _rc(*args, **kwargs)


def run_lint(*args, **kwargs):
    from .lint import run_lint as _rl

    return _rl(*args, **kwargs)


def run_launch_audit(*args, **kwargs):
    from .launch_audit import run_launch_audit as _ra

    return _ra(*args, **kwargs)


def _require_device(device: str) -> None:
    """Raise :class:`DeviceUnavailable` unless ``device`` is ``"cpu"`` or
    ``"cuda"`` with a CUDA device present."""
    if device not in ("cpu", "cuda"):
        raise DeviceUnavailable(f"unknown device {device!r} (cuda or cpu)")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "no CUDA device: pass --device cpu (device=\"cpu\") to audit "
                "the CPU path")


def run_all(passes=PASSES, device: str = "cuda", report=None):
    """All findings from the selected passes, baseline/noqa applied to
    lint (the other passes have no baseline — a contract either holds or
    the build is wrong). The launch audit runs on ``device`` (the card by
    default); a missing device raises :class:`DeviceUnavailable` before any
    pass runs. ``report``, where given, collects the launch audit's
    numbers."""
    _require_device(device)
    findings = []
    if "contracts" in passes:
        findings.extend(run_contracts())
    if "lint" in passes:
        from .lint import apply_baseline, load_baseline

        findings.extend(apply_baseline(run_lint(), load_baseline()))
    if "launch" in passes:
        findings.extend(run_launch_audit(device=device, report=report))
    return findings
