"""Public wrapper of the SSD chunk-scan kernel, signature-compatible with
``ref.ssd_reference`` (so ``models/mamba2.py`` swaps implementations by
``RunFlags.ssd_impl``). Returns ``(y, h_final)``: y in x's dtype, h_final
(B, H, P, N) in f32.

The device of the inputs picks the path, and nothing else does:

  * CUDA tensors launch the kernel (``kernel.ssd_cuda``) or raise; a failed
    build or launch is never caught. On the tensor-core route x, B and C go
    in as they are (the model's slices of one projection, read in place);
    on the CUDA-core route they are made contiguous;
  * CPU tensors run the plain version (``ref.ssd_reference``);
  * any other device raises.

It keeps the reference's contract: ``chunk = min(chunk, S)`` must divide S.

A DTensor x (a step on a mesh) runs the same wrapper on each device's
shards (``sharding.act.on_shards``), before the kernel/plain choice: the
sequence, P and N, which the kernel scans and reduces, are whole on every
device; the batch rows and the heads keep their sharding (x, dt and a
sharded alike on the heads, B and C whole over them). Grouped B and C
(B, S, G, N) take a batch split only: a head split of a grouped call
raises.

The kernel has no backward: under autograd (grad enabled and an input that
needs a gradient) the call raises ``NotImplementedError`` rather than
return a result that cuts the gradient. Mamba training runs
``ssd_impl="reference"`` (plain autograd, as the reference trains).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ...sharding.act import on_shards
from .kernel import kernel_reads, route, ssd_cuda
from .ref import ssd_reference

SSD_GRAD_TODO = ("the SSD kernel has no backward yet (ROADMAP queue 1: Mamba training with an SSD "
                 "backward kernel); train Mamba-2 with RunFlags(ssd_impl=\"reference\")")


def ssd(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    a: torch.Tensor,  # (H,)
    b_mat: torch.Tensor,  # (B, S, N), or (B, S, G, N): head h reads group h // (H / G)
    c_mat: torch.Tensor,  # as b_mat
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if isinstance(x, DTensor):
        return on_mesh(partial(ssd, chunk=chunk), x, dt, a, b_mat, c_mat)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b_mat, c_mat)):
        raise NotImplementedError(SSD_GRAD_TODO)
    s = x.shape[1]
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence length {s}")
    if x.device.type == "cuda":
        # the kernel takes dt and a in f32 (the Pallas kernel casts them)
        dt, a = dt.float(), a.float().contiguous()
        if route(x.dtype, b_mat.dtype, chunk, x.shape[-1], b_mat.shape[-1]) == "tensor_cores":
            x, b_mat, c_mat = (t if kernel_reads(t) else t.contiguous() for t in (x, b_mat, c_mat))
            return ssd_cuda(x, dt, a, b_mat, c_mat, chunk)
        return ssd_cuda(x.contiguous(), dt.contiguous(), a, b_mat.contiguous(), c_mat.contiguous(), chunk)
    if x.device.type == "cpu":
        return ssd_reference(x, dt, a, b_mat, c_mat, chunk=chunk)
    raise ValueError(f"ssd: no path for tensors on {x.device}")


def on_mesh(fn, x: DTensor, dt, a, b_mat, c_mat):
    """An SSD ``fn(x, dt, a, b_mat, c_mat)`` (this wrapper, or the plain
    ``ssd_reference``) on each device's shards: batch rows and heads as
    sharded; sequence, P and N whole. Per mesh dim: x's batch split splits
    dt, B, C, y and h alike; x's head split splits dt and a alike (h on its
    dim 1) and leaves B and C whole, which a grouped B and C (B, S, G, N)
    cannot take: their groups would have to split with the heads."""
    if b_mat.dim() == 4 and Shard(2) in x.placements:
        raise NotImplementedError("ssd: grouped B and C (B, S, G, N) with the heads split over a mesh")
    whole = Replicate()
    rows = {Shard(0): (Shard(0), Shard(0), whole, Shard(0), Shard(0)),  # x, dt, a, B/C, h
            Shard(2): (Shard(2), Shard(2), Shard(0), whole, Shard(1))}
    x_pl, dt_pl, a_pl, bc_pl, h_pl = zip(*(rows.get(p, (whole,) * 5) for p in x.placements))
    return on_shards(fn, (x, dt, a, b_mat, c_mat),
                     (x_pl, dt_pl, a_pl, bc_pl, bc_pl), [x_pl, h_pl], work=x_pl)
