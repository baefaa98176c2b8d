"""MoE position-in-expert kernel (CUDA, Hopper).

``ops.moe_positions`` gives each flat (token, k) assignment its rank among
the earlier assignments to the same expert, the integers of the reference's
token-major one-hot cumsum; ``ref.positions_reference`` is that one-hot
cumsum, the plain PyTorch version it is tested against.
"""
from .ops import moe_positions
from .ref import positions_reference

__all__ = ["moe_positions", "positions_reference"]
