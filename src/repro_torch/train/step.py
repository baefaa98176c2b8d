"""Training and serving step functions of the decoder: the torch
counterparts of the reference's ``repro.train.step``.

``make_train_step``: CE loss (+ MoE aux, 0 for the dense stacks) → grads →
clip → AdamW, with gradient accumulation over microbatches. The state is a
plain dict {params (a ``Model`` whose parameters require grad), opt {m, v,
count}, step}; the step updates its tensors IN PLACE (the reference's
launcher donates the state) and returns it.
``make_prefill_step`` / ``make_decode_step``: batched serving with the
KV/SSM cache, both in bf16.

On a mesh (a state placed by ``runtime.elastic.reshard_state``, the step
called under ``sharding.act.activation_rules``) the same step runs on
DTensors: the batch is the global batch on every rank, split into
microbatches without gathering it, the constraints pin the hidden state
and the logits as the reference's do, the LM head is placed for a local
product (batch over the data axes, vocab or, where the vocab does not
split, sequence over the model axis) whose CE reduces over the vocab
shards by small all-reduces, and the loss and metrics come back as whole
values.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models.model import (
    HEAD_USE,
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
from ..sharding.act import (
    constrain,
    current_context,
    in_context,
    local_product,
    replicated,
    use_weight,
    weights_as_placed,
    whole,
)
from ..sharding.rules import axes, resolve
from ..sharding.specs import batch_logical

AUX_LOSS_WEIGHT = 0.01
LOSS_CHUNKS = 8  # sequence chunks for the streamed LM-head CE

_F32 = torch.float32


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit. A gather on plain tensors; on a DTensor, whose
    vocab may be sharded over the model axis, the reference's masked
    reduction over the vocab (DTensor's gather along a sharded dim fails),
    which picks the same element exactly."""
    if isinstance(logits, DTensor):  # the vocab ids placed as the logits' vocab dim
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        vocab = replicated(vocab, logits.device_mesh).redistribute(
            logits.device_mesh, [Shard(0) if p == Shard(logits.ndim - 1) else Replicate()
                                 for p in logits.placements])
        return torch.where(vocab == labels[..., None], logits, 0.0).sum(-1)
    return logits.gather(-1, labels[..., None].long())[..., 0]


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the vocab. Where a DTensor splits the vocab over
    devices, as the reductions DTensor shards (its ``logsumexp`` would
    gather the logits whole): the row max, detached, and the sum of
    exponentials, each a small all-reduce of one value a row. Elsewhere
    ``torch.logsumexp`` itself, so a mesh whose vocab dim is one device
    computes the unsharded step's bits."""
    if not isinstance(logits, DTensor) or not any(
            p == Shard(logits.ndim - 1) and logits.device_mesh.size(i) > 1
            for i, p in enumerate(logits.placements)):
        return torch.logsumexp(logits, -1)
    m = _reduced(logits.detach().amax(-1, keepdim=True))
    return _reduced(torch.exp(logits - m).sum(-1)).log() + m[..., 0]


def _reduced(x: DTensor) -> DTensor:
    """A DTensor's ``Partial`` placements reduced to whole values (an
    all-reduce), the rest kept: left to itself DTensor may reduce-scatter a
    row sum over the batch rows, whose gradient then comes back in a layout
    the vocab shards must be all-to-all'd into."""
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in x.placements])


def _token_ce(logits: torch.Tensor, labels: torch.Tensor, seq: str = "seq") -> torch.Tensor:
    """Each token's CE (B, S). On a mesh the two per-token terms are pinned
    to the tokens' layout (each an all-reduce of one value a token over a
    split vocab), so their gradients come back in it and broadcast over the
    vocab shards locally."""
    per_token = ("batch", seq)
    return constrain(_logsumexp(logits), per_token) - constrain(_gold(logits, labels), per_token)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits f32 (B, S, V); labels integer (B, S)."""
    return _token_ce(logits, labels).mean()


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """f32 master weights from ``init_params(cfg, seed)`` (requiring grad),
    zero AdamW moments, step 0; on ``device`` (CUDA by default)."""
    params = init_params(cfg, seed, dtype=_F32, device=device).requires_grad_(True)
    return {"params": params, "opt": adamw.init(dict(params.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=params.device)}


def _head_seq(vocab: int) -> str:
    """The logical axis of the LM head's sequence dim on a mesh: ``seq``
    where the vocab splits over the model axis, else ``seq_res`` (the
    sequence over the model axis), so that the model-axis devices share the
    head's rows (mamba2's 50,280 over 16) rather than each computing all."""
    ctx = current_context()
    if ctx is None or resolve((vocab,), ("act_vocab",), ctx[0], axes(ctx[1]))[0] is not None:
        return "seq"
    return "seq_res"


def _chunk_ce(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # the reference's bf16 product with f32 accumulation and f32 logits: the
    # operands widen to f32 exactly, so only the summation order differs.
    # On a mesh the head is placed for a local product (HEAD_USE): batch
    # over the data axes times vocab (or sequence) over the model axis
    seq = _head_seq(head_w.shape[-1])
    h, labels = constrain(h, ("batch", seq, "act_embed")), constrain(labels, ("batch", seq))
    head_w = use_weight(head_w, HEAD_USE)
    product = local_product if isinstance(h, DTensor) else torch.matmul
    logits = constrain(product(h.to(_F32), head_w.to(_F32)), ("batch", seq, "act_vocab"))
    return _token_ce(logits, labels, seq).sum()


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
        chunk = in_context(_chunk_ce)  # the recompute constrains as the forward did
        fn = lambda *a: checkpoint(chunk, *a, use_reentrant=False)  # noqa: E731
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
    positions (3, B, S) along their second dim), as the reference splits,
    one slice at a time. A DTensor whose B is sharded is first moved to
    shard the dim after B instead (an all-to-all of its own size), so each
    slice is a local one; each slice is then moved back (DTensor's slice of
    a sharded dim would gather the whole batch: qwen2-vl's 3.2 GB of
    embeddings a slice)."""
    if n == 1:
        yield batch
        return
    bdims = {k: 1 if k == "mrope_positions" else 0 for k in batch}
    moved = {k: _batch_whole(a, bdims[k]) for k, a in batch.items()}
    for i in range(n):
        mb = {}
        for k, a in moved.items():
            rows = a.shape[bdims[k]] // n
            piece = a.narrow(bdims[k], i * rows, rows)
            if isinstance(a, DTensor) and a.placements != batch[k].placements:
                piece = piece.redistribute(a.device_mesh, batch[k].placements)
            mb[k] = piece
        yield mb


def _batch_whole(a: torch.Tensor, bdim: int) -> torch.Tensor:
    """A batch tensor with its B dim whole: a DTensor's mesh dims that shard
    B shard the next dim instead, where it divides (else ``a`` as it is)."""
    if not isinstance(a, DTensor) or Shard(bdim) not in a.placements or a.ndim <= bdim + 1:
        return a
    mesh = a.device_mesh
    split = math.prod(mesh.size(i) for i, p in enumerate(a.placements) if p == Shard(bdim))
    already = math.prod(mesh.size(i) for i, p in enumerate(a.placements) if p == Shard(bdim + 1))
    if a.shape[bdim + 1] % (split * already):
        return a
    return a.redistribute(mesh, [Shard(bdim + 1) if p == Shard(bdim) else p for p in a.placements])


def make_train_step(
    cfg: ModelConfig,
    flags: RunFlags,
    opt_cfg: adamw.AdamWConfig,
    microbatches: int = 1,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Training step with optional gradient accumulation: the global batch
    is split into ``microbatches`` sequential chunks whose f32 grads
    accumulate, then average, before one AdamW update. Each microbatch's
    forward and backward run before the next starts, so only one
    microbatch's activations are live. ``compute_dtype`` is the forward's
    (the reference's bf16; f32 for parity checks whose bar is f32's)."""

    def loss_fn(params: Model, mb):
        hidden, aux = forward_hidden(params, cfg, mb, flags, compute_dtype)
        # re-gather the SP-sharded sequence before the chunked head
        hidden = constrain(hidden, ("batch", None, "act_embed"))
        ce = chunked_ce_loss(hidden, head_matrix(params, cfg, compute_dtype), mb["labels"])
        loss = ce + AUX_LOSS_WEIGHT * aux
        if isinstance(loss, DTensor):  # differentiate the one global loss, not per-rank shares
            loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
        return loss, ce, aux

    logical = batch_logical(cfg, "train")

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params: Model = state["params"]
        named = dict(params.named_parameters())
        batch = _to_device(batch, params.device)
        if batch["labels"].shape[0] % microbatches:
            raise ValueError(f"batch of {batch['labels'].shape[0]} does not split into {microbatches}")
        grads, ce, aux = None, 0.0, 0.0
        for mb in _microbatches(batch, microbatches):
            # a slice of a batch-sharded dim comes back whole: shard it again
            mb = {k: constrain(v, logical[k]) if k in logical else v for k, v in mb.items()}
            loss, ce_i, aux_i = loss_fn(params, mb)
            g = torch.autograd.grad(loss, list(named.values()))
            # from the second microbatch on, g is a second f32 gradient tree
            # beside the accumulator: the MoE step on the card (Qwen3-MoE,
            # one layer at full width) runs with microbatches=1 to fit
            if grads is None:
                grads = [x.to(_F32) for x in g]
            else:
                torch._foreach_add_(grads, [x.to(_F32) for x in g])
            ce, aux = ce + whole(ce_i.detach()), aux + whole(aux_i.detach())
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
        forward's. On a mesh the weights stay on their FSDP shards
        (``sharding.act.weights_as_placed``), as in decode."""
        with weights_as_placed():
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
