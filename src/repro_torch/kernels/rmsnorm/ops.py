"""Public wrapper of the RMSNorm kernel: x of shape (..., d), normalised
over its last axis.

The device of the inputs picks the path, and nothing else does:

  * CUDA tensors launch the kernel (``kernel.rmsnorm_cuda``) or raise; a
    failed build or launch is never caught;
  * CPU tensors run the plain version (``ref.rmsnorm_reference``);
  * any other device raises.

Under autograd (grad enabled and x or w needing a gradient) the call goes
through :class:`RMSNorm`, a ``torch.autograd.Function``: its forward is the
same kernel (or plain version), its backward the analytic gradient of
``layers.rms_norm`` in plain torch, in f32, cast to the inputs' dtypes (the
reference trains through the plain ``rms_norm``; no backward kernel exists
there). Without autograd the call is a bare launch, as decode needs.

A DTensor input (a step on a mesh) runs the same wrapper on each device's
shard (``sharding.act.on_shards``): x is redistributed so that its last
axis, the one the kernel reduces, is whole on every device (its other axes
keep their sharding) and w is whole; on CUDA tensors every shard launches
the kernel. This dispatch comes before the kernel/plain choice, so the
CPU tests hold the same placements through the plain version.

``row_block`` is the reference's tiling knob and is kept in the signature;
the CUDA kernel picks its own tiling (a warp or a block per row), so here
any row count works, where the Pallas kernel needs ``row_block`` to divide it.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ...sharding.act import on_shards
from .kernel import rmsnorm_cuda
from .ref import rmsnorm_reference


def _rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float):
    """(dx, dw) of y = x · rsqrt(mean(x²) + eps) · (1 + w), in f32: with
    r = rsqrt(mean(x²) + eps), x̂ = x r and g = dy (1 + w),
    dx = r (g − x̂ mean(g x̂)) and dw = Σ_rows dy x̂."""
    xf, gf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xhat = xf * r
    g = gf * (1.0 + w.float())
    dx = r * (g - xhat * (g * xhat).mean(-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


class RMSNorm(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU); backward:
    :func:`_rmsnorm_bwd` on the saved (x, w)."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _rmsnorm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.is_cuda:
        if x.dim() == 2:  # no views to make: the decode and prefill rows of a 2-D call
            return rmsnorm_cuda(x.contiguous(), w.contiguous(), eps)
        return rmsnorm_cuda(x.reshape(-1, x.shape[-1]).contiguous(), w.contiguous(), eps).view(x.shape)
    if x.device.type == "cpu":
        return rmsnorm_reference(x, w, eps)
    raise ValueError(f"rmsnorm: no path for tensors on {x.device}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            row_block: int = 256) -> torch.Tensor:
    if row_block <= 0:
        raise ValueError(f"row_block must be positive, got {row_block}")
    if isinstance(x, DTensor):
        return _on_mesh(x, w, eps)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps)


def _on_mesh(x: DTensor, w: torch.Tensor, eps: float) -> DTensor:
    """The normalised axis whole on every device, the rows as sharded."""
    last = x.ndim - 1
    pl = tuple(p if isinstance(p, Shard) and p.dim != last else Replicate() for p in x.placements)
    whole_w = (Replicate(),) * len(pl)
    return on_shards(lambda a, b: rmsnorm(a, b, eps), (x, w), (pl, whole_w), [pl], work=pl)
