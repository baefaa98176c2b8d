"""Plain PyTorch version of the phase-sim kernel.

It *is* the port's batched simulator — ``phase_sim_torch.simulate_batch``,
re-exported here so the kernel package keeps the ``{kernel,ops,ref}``
layout without a second copy of the simulator physics. The CUDA kernel is
held against this function (≤ 1e-5 relative on every output column) on the
card, and the CPU tests hold this function against the JAX reference.
"""
from __future__ import annotations

from ...core.phase_sim_torch import phase_sim_plain, simulate_batch

phase_sim_ref = simulate_batch

__all__ = ["phase_sim_plain", "phase_sim_ref"]
