"""Training and serving step functions of the decoder: the torch
counterparts of the reference's ``repro.train.step``.

``make_train_step``: CE loss (+ MoE aux, 0 for the dense stacks) → grads →
clip → AdamW, with gradient accumulation over microbatches. The state is a
plain dict {params (a ``Model`` whose parameters require grad), opt {m, v,
count}, step}; the step updates its tensors IN PLACE (the reference's
launcher donates the state) and returns it.
``make_prefill_step`` / ``make_decode_step``: batched serving with the
KV/SSM cache, both in bf16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models.model import (
    Model,
    RunFlags,
    _head,
    _sequence,
    cast_params,
    forward_hidden,
    head_matrix,
    init_params,
    norm_fn,
)
from ..models.model import decode_step as model_decode
from ..optim import adamw

AUX_LOSS_WEIGHT = 0.01
LOSS_CHUNKS = 8  # sequence chunks for the streamed LM-head CE

_F32 = torch.float32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits f32 (B, S, V); labels integer (B, S). The
    gold logit is gathered (the reference's masked reduction over the vocab
    picks the same element: it exists there for a vocab-sharded mesh)."""
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """f32 master weights from ``init_params(cfg, seed)`` (requiring grad),
    zero AdamW moments, step 0; on ``device`` (CUDA by default)."""
    params = init_params(cfg, seed, dtype=_F32, device=device).requires_grad_(True)
    return {"params": params, "opt": adamw.init(dict(params.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=params.device)}


def _chunk_ce(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # the reference's bf16 product with f32 accumulation and f32 logits: the
    # operands widen to f32 exactly, so only the summation order differs
    logits = torch.matmul(h.to(_F32), head_w.to(_F32))
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def chunked_ce_loss(
    hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor, n_chunks: int = LOSS_CHUNKS
) -> torch.Tensor:
    """Streamed LM-head + CE: logits are produced one sequence chunk at a
    time, each chunk under ``torch.utils.checkpoint`` where autograd
    records, so only a (B, S/n, V) f32 block is ever live (forward *and*
    backward) instead of the full (B, S, V) logits."""
    b, s, _ = hidden.shape
    while s % n_chunks:
        n_chunks //= 2
    cs = s // n_chunks
    fn = _chunk_ce
    if torch.is_grad_enabled():
        fn = lambda *a: checkpoint(_chunk_ce, *a, use_reentrant=False)  # noqa: E731
    tot = torch.zeros((), dtype=_F32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * cs, (c + 1) * cs)
        tot = tot + fn(hidden[:, sl], head_w, labels[:, sl])
    return tot / (b * s)


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """Batch arrays (numpy or tensors) on ``device``; integer ones as int64
    (torch indexes and gathers with them)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    """The batch split along B into ``n`` consecutive slices (M-RoPE
    positions (3, B, S) along their second dim), as the reference splits."""
    def split(key, a, i):
        bdim = 1 if key == "mrope_positions" else 0
        rows = a.shape[bdim] // n
        return a.narrow(bdim, i * rows, rows)

    return [{k: split(k, v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(
    cfg: ModelConfig,
    flags: RunFlags,
    opt_cfg: adamw.AdamWConfig,
    microbatches: int = 1,
):
    """Training step with optional gradient accumulation: the global batch
    is split into ``microbatches`` sequential chunks whose f32 grads
    accumulate, then average, before one AdamW update. Each microbatch's
    forward and backward run before the next starts, so only one
    microbatch's activations are live."""

    def loss_fn(params: Model, mb):
        hidden, aux = forward_hidden(params, cfg, mb, flags)
        ce = chunked_ce_loss(hidden, head_matrix(params, cfg), mb["labels"])
        return ce + AUX_LOSS_WEIGHT * aux, ce, aux

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params: Model = state["params"]
        named = dict(params.named_parameters())
        batch = _to_device(batch, params.device)
        if batch["labels"].shape[0] % microbatches:
            raise ValueError(f"batch of {batch['labels'].shape[0]} does not split into {microbatches}")
        grads, ce, aux = None, 0.0, 0.0
        for mb in _microbatches(batch, microbatches):
            loss, ce_i, aux_i = loss_fn(params, mb)
            g = torch.autograd.grad(loss, list(named.values()))
            # from the second microbatch on, g is a second f32 gradient tree
            # beside the accumulator: the MoE step on the card (Qwen3-MoE,
            # one layer at full width) runs with microbatches=1 to fit
            if grads is None:
                grads = [x.to(_F32) for x in g]
            else:
                torch._foreach_add_(grads, [x.to(_F32) for x in g])
            ce, aux = ce + ce_i.detach(), aux + aux_i.detach()
        if microbatches > 1:
            torch._foreach_div_(grads, float(microbatches))
            ce, aux = ce / microbatches, aux / microbatches
        _, opt, om = adamw.update(dict(zip(named, grads)), state["opt"], named, opt_cfg)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": ce, "aux_loss": aux, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, flags: RunFlags):
    def prefill_step(params: Model, batch: Dict[str, torch.Tensor]):
        """(last-position logits (B, V) f32, per-layer cache: KV or the
        Mamba-2 conv window and SSM state). The head runs on the last
        position only: it is row-wise, so those logits are the full
        forward's."""
        p = cast_params(params, torch.bfloat16)
        x, cache, _ = _sequence(p, cfg, batch, flags, torch.bfloat16, True)
        return _head(p, cfg, x[:, -1:], norm_fn(flags))[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, flags: RunFlags):
    def decode_step(params: Model, cache, batch: Dict[str, torch.Tensor], cur_index: int):
        """(logits (B, V) f32, cache updated in place)."""
        logits, cache = model_decode(params, cfg, cache, batch, cur_index, flags,
                                     compute_dtype=torch.bfloat16)
        return logits[:, -1], cache

    return decode_step
