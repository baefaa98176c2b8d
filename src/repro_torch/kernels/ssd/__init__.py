"""Mamba-2 SSD chunk-scan kernel (CUDA, Hopper).

``ops.ssd`` is the drop-in counterpart of the reference's
``repro.kernels.ssd.ops.ssd`` (returns ``(y, h_final)``);
``ref.ssd_reference`` (chunked) and ``ref.ssd_naive`` (token by token) are
the plain PyTorch versions it is tested against, and ``ref.ssd_decode_step``
is the one-token update of the serving path.
"""
from .ops import ssd
from .ref import ssd_decode_step, ssd_naive, ssd_reference

__all__ = ["ssd", "ssd_decode_step", "ssd_naive", "ssd_reference"]
