"""The RMSNorm kernel's plain PyTorch version: the same math as
``models.layers.rms_norm`` (f32 mean of squares, ``rsqrt(var + eps)``, a
scale by ``1 + w``, the output in x's dtype)."""
from ...models.layers import rms_norm as rmsnorm_reference  # noqa: F401
