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

The block sizes keep the reference's contract (each divides the sequence,
after clipping to it; H is a multiple of KH). The CUDA kernel picks its own
tiles, so on the card they constrain the call and nothing else.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda, kernel_reads
from .ref import attention_reference


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
    if q.device.type == "cuda":
        q, k, v = (x if kernel_reads(x) else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out = flash_attention_cuda(qt, kt, vt, causal=causal)
    elif q.device.type == "cpu":
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out = attention_reference(qt, kt, vt, causal=causal)
    else:
        raise ValueError(f"flash_attention: no path for tensors on {q.device}")
    return out.transpose(1, 2)
