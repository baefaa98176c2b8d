"""Public wrapper of the flash-attention kernel, in the model layout
(B, S, H, Dh).

The device of the inputs picks the path, and nothing else does:

  * CUDA tensors launch the kernel (``kernel.flash_attention_cuda``) or
    raise; a failed build or launch is never caught. The kernel reads q, k
    and v in place through their strides (transposed views, no copies) and
    writes a contiguous (B, S, H, Dh) output, so the model's
    ``out.reshape(b, s, -1)`` is a view. Only an input whose strides the
    kernel cannot read (a head dim that is not contiguous, or a stride that
    is no multiple of 16 bytes, which no model path makes) is copied first;
  * CPU tensors run the plain version (``ref.attention_reference``);
  * any other device raises.

Under autograd (grad enabled and an input that needs a gradient) the call
goes through :class:`FlashAttention`, a ``torch.autograd.Function``: its
forward is the kernel, which then also writes each row's log-sum-exp (on
CPU tensors ``models.flash_ref._fwd_impl``), and its backward the
reference's plain flash backward (``models.flash_ref._bwd_impl``) on the
saved (q, k, v, out, lse), in f32 torch products. No backward kernel
exists in the reference (its Pallas wrapper has no VJP), so none is ported.
Without autograd the call saves nothing and writes no lse.

A DTensor input (a step on a mesh) runs the same wrapper on each device's
shards (``sharding.act.on_shards``), before the kernel/plain choice: the
sequence and the head dim, which the kernel scans and reduces, are made
whole on every device; the batch and the query heads keep their sharding,
since attention is local to each (batch row, head). The KV heads keep
theirs where they are sharded as the query heads are; otherwise they are
whole on every device, and each device takes the KV heads its own query
heads read (GQA: query head h reads KV head h // (H / KH)).

The block sizes keep the reference's contract (each divides the sequence,
after clipping to it; H is a multiple of KH). The CUDA kernel picks its own
tiles, so on the card they constrain the forward and set the backward's
blocks.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ...models.flash_ref import _bwd_impl, _fwd_impl
from ...sharding.act import on_shards
from .kernel import flash_attention_cuda, kernel_reads
from .ref import attention_reference


def _kernel_inputs(q, k, v):
    """(B, H, S, Dh) views the kernel reads in place (a copy only where it
    cannot)."""
    q, k, v = (x if kernel_reads(x) else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    return (x.transpose(1, 2) for x in (q, k, v))


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel with the row log-sum-exp (CUDA tensors) or
    ``flash_ref._fwd_impl`` (CPU tensors); backward: ``flash_ref._bwd_impl``
    on the saved (q, k, v, out, lse (B, S, KH, G) f32)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_block: int, kv_block: int):
        b, s, h, _ = q.shape
        if q.device.type == "cuda":
            lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
            out = flash_attention_cuda(*_kernel_inputs(q, k, v), causal=causal, lse=lse).transpose(1, 2)
            lse = lse.view(b, s, k.shape[2], h // k.shape[2])
        else:
            out, lse = _fwd_impl(q, k, v, causal, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _bwd_impl(*ctx.saved_tensors, dout, *ctx.blocks)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, Dh) — model layout
    k: torch.Tensor,  # (B, S, KH, Dh)
    v: torch.Tensor,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 512,
) -> torch.Tensor:
    sq, h = q.shape[1], q.shape[2]
    skv, kh = k.shape[1], k.shape[2]
    q_block, kv_block = min(q_block, sq), min(kv_block, skv)
    if q_block <= 0 or kv_block <= 0 or sq % q_block or skv % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) must divide the sequences ({sq}, {skv})")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} KV heads")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no path for tensors on {q.device}")
    if isinstance(q, DTensor):
        return _on_mesh(q, k, v, causal, q_block, kv_block)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_block, kv_block)
    if q.device.type == "cuda":
        return flash_attention_cuda(*_kernel_inputs(q, k, v), causal=causal).transpose(1, 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return attention_reference(qt, kt, vt, causal=causal).transpose(1, 2)


def _on_mesh(q: DTensor, k, v, causal: bool, q_block: int, kv_block: int) -> DTensor:
    """Batch rows and query heads as sharded, sequence and head dim whole;
    KV heads sharded with the query heads, or whole and sliced per device."""
    mesh = q.device_mesh
    whole = (Replicate(),) * mesh.ndim
    q_pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in q.placements)
    k_in = k.placements if isinstance(k, DTensor) else whole
    heads = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    kv_heads_sharded = all(k_in[i] == Shard(2) for i in heads)
    kv_pl = tuple(Shard(0) if p == Shard(0) else (Shard(2) if p == Shard(2) and kv_heads_sharded
                                                  else Replicate()) for p in q_pl)
    h, kh = q.shape[2], k.shape[2]
    h_loc = h // math.prod(mesh.size(i) for i in heads)
    kv_slice = None
    if heads and not kv_heads_sharded:  # this device's query heads, and the KV heads they read
        g = h // kh
        if h_loc % g and g % h_loc:
            raise ValueError(f"{h_loc} query heads a device do not group over {kh} KV heads")
        coord = 0
        for i in heads:
            coord = coord * mesh.size(i) + mesh.get_local_rank(i)
        start = coord * h_loc // g
        kv_slice = slice(start, start + max(h_loc // g, 1))

    def local(ql, kl, vl):
        if kv_slice is not None:
            kl, vl = kl[:, :, kv_slice], vl[:, :, kv_slice]
        return flash_attention(ql, kl, vl, causal, q_block, kv_block)

    return on_shards(local, (q, k, v), (q_pl, kv_pl, kv_pl), [q_pl], work=q_pl)
