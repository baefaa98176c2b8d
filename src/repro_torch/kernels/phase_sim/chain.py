"""In-loop re-simulation for the device-resident explorer.

The fused accept loop (``repro_torch.core.device_explore``) mutates R chain
encodings per iteration and needs their ``fitness`` plus the per-slot
bottleneck telemetry columns (``pe_bneck_s``/``mem_bneck_s``) back inside
the same step, with no host round trip. The chains ARE the batch axis:
every iteration prices an (R,)-rows dict, which is exactly the contract of
the batched simulator, so the loop prices through ``ops.phase_sim``. The
rows' device picks the path there, as everywhere in the port: CUDA rows
launch the phase-sim kernel (one launch per iteration), CPU rows run its
plain PyTorch version.

Mixed mapping+allocation chains price through the SAME call: allocation
moves are shape-preserving over capacity-padded slot inventories, so a
fork/join/swap/NoC-attach step still hands this function an (R,)-rows dict
— the per-slot coefficient columns are (R, cap) wide with
``pe_active``/``mem_active`` masks pricing inactive slots as absent (zero
leak/area contribution, pad-neutral rates). The move semantics live entirely
in the carry mutations upstream.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...core.phase_sim_torch import EncodedWorkload
from .ops import phase_sim

__all__ = ["resimulate_chains"]


def resimulate_chains(  # repro_torch: hot
    enc: EncodedWorkload, rows: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Price the R mutated chain encodings of one accept-loop iteration.

    ``rows`` is a batched rows dict with the chain axis leading (R designs,
    one per chain), contiguous, on one device. Never synchronises."""
    return phase_sim(enc, rows)
