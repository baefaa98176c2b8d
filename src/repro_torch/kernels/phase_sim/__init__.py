"""Fused phase-driven simulator kernel (CUDA, Hopper).

One launch prices a whole candidate batch: one thread block per design, one
thread per task, running the design's whole phase loop. ``ops.phase_sim``
is the drop-in counterpart of ``repro_torch.core.phase_sim_torch.
simulate_batch`` (same rows dict in, same output dict out);
``ref.phase_sim_ref`` is the plain PyTorch version it is tested against;
``chain.resimulate_chains`` prices the chain block's R platforms per
iteration through ``ops.phase_sim``.
"""
from .chain import resimulate_chains
from .ops import phase_sim, phase_sim_rows
from .ref import phase_sim_ref

__all__ = ["phase_sim", "phase_sim_ref", "phase_sim_rows", "resimulate_chains"]
