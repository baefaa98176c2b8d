"""Generic decoder stack: instantiates the attention and Mamba-2
architectures from their ``ModelConfig``; the torch counterpart of
``repro.models.model``.

Layers are grouped into a repeating *cycle* of positions as in the
reference; where the reference scans over cycles (``lax.scan``), the port
loops over layers in Python, layer ``i`` sitting at cycle position
``i % cycle_len``. Two execution modes share one block implementation:

  prefill  — full sequence (``forward``), optionally emitting a per-layer
             cache (KV, or the Mamba-2 conv window and SSM state)
  decode   — one token against the cache (``decode_step``), which is
             updated IN PLACE (the reference returns a new cache)

Parameters live in a :class:`Model`, a module tree that mirrors the
reference's pytree key for key, one entry of ``layers`` per layer (the
reference stacks each cycle position over cycles). Everything runs on the
device of the parameters; the constructors default to CUDA and raise
without it. Every block kind of the reference is ported: attention and
Mamba-2 sequence mixers, dense and MoE channel mixers (``models.moe``).

Two ``RunFlags`` switches send the stack through the port's CUDA kernels
(their plain versions on CPU tensors): ``ssd_impl="kernel"`` runs every
Mamba-2 prefill SSD through ``kernels.ssd.ops.ssd`` (the reference's model
always calls ``ssd_reference``; its ``mamba2_apply(ssd_fn=...)`` is the swap
point), and ``norm_impl="kernel"`` runs every RMSNorm of the stack (norm1,
norm2, q/k-norm, the Mamba gated norm and the final norm) through
``kernels.rmsnorm.ops.rmsnorm``. The defaults are the reference's plain
functions.

Training differentiates ``forward_hidden`` (``train.step``): the kernel
wrappers then go through their ``torch.autograd.Function``s (flash and
RMSNorm; the SSD kernel has no backward and raises), and
``RunFlags.remat`` recomputes each cycle's activations in the backward as
the reference's ``jax.checkpoint`` of its cycle body does. Serving runs
under ``torch.inference_mode`` and records nothing.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.rmsnorm.ops import rmsnorm
from ..kernels.ssd.ops import on_mesh as ssd_on_mesh
from ..kernels.ssd.ops import ssd
from ..kernels.ssd.ref import ssd_reference
from ..sharding.act import (
    attention_on_shards,
    constrain,
    current_context,
    in_context,
    local_product,
    merge_heads,
    unflatten,
    use_weight,
    weights_as_placed,
    write_position,
)
from ..sharding.rules import axes
from .flash_ref import flash_attention_ref
from .layers import (
    _mm,
    apply_mrope,
    apply_rope,
    attention_decode,
    attention_full,
    mlp_apply,
    rms_norm,
)
from .mamba2 import mamba2_cache_init, mamba2_decode, mamba2_init, mamba2_prefill
from .moe import moe_apply, moe_init
from .moe_shard_map import moe_apply_shard_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Per-call execution knobs: the reference's attention knobs, ``remat``,
    ``ssd_chunk`` and ``moe_impl``, and the port's kernel switches
    ``ssd_impl`` and ``norm_impl`` (module docstring). ``moe_impl =
    "shard_map"`` takes ``models.moe_shard_map`` (local dispatch, expert
    all-to-all) in sequence mode under an ``activation_rules`` context whose
    model axis the experts divide; everywhere else it computes the dense
    path, as the reference does."""

    attn_impl: str = "auto"  # "auto" | "full" | "blockwise" | "kernel"
    q_block: int = 512
    kv_block: int = 1024
    remat: str = "none"  # "none" | "full" | "dots"
    ssd_chunk: int = 64
    ssd_impl: str = "reference"  # "reference" | "kernel"
    norm_impl: str = "reference"  # "reference" | "kernel"
    moe_impl: str = "dense"  # "dense" | "shard_map" (EP local dispatch under a mesh context)


def norm_fn(flags: RunFlags) -> Callable:
    """The RMSNorm ``flags.norm_impl`` selects: ``layers.rms_norm`` or the
    kernel's ``ops.rmsnorm`` (same signature ``(x, w, eps)``)."""
    if flags.norm_impl == "reference":
        return rms_norm
    if flags.norm_impl == "kernel":
        return rmsnorm
    raise ValueError(f"unknown norm_impl {flags.norm_impl!r}")


def _shard_map_moe(flags: RunFlags, cfg: ModelConfig) -> bool:
    """Whether a sequence-mode MoE layer takes ``moe_apply_shard_map``
    rather than ``moe_apply``: as in the reference, where ``moe_impl ==
    "shard_map"``, a context is installed and the experts divide the model
    axis (EP)."""
    if flags.moe_impl not in ("dense", "shard_map"):
        raise ValueError(f"unknown moe_impl {flags.moe_impl!r}")
    ctx = current_context()
    return (flags.moe_impl == "shard_map" and ctx is not None
            and cfg.n_experts % axes(ctx[1]).shape.get("model", 1) == 0)


def _ssd_fn(flags: RunFlags, s: int) -> Callable:
    impl = {"reference": _ssd_reference, "kernel": ssd}.get(flags.ssd_impl)
    if impl is None:
        raise ValueError(f"unknown ssd_impl {flags.ssd_impl!r}")
    return partial(impl, chunk=min(flags.ssd_chunk, s))


def _ssd_reference(x, dt, a, b_mat, c_mat, chunk: int):
    """The plain SSD; on a mesh on each device's shards, as the kernel's
    wrapper runs (DTensor cannot flatten its chunked einsums' dims that two
    mesh dims shard, on the card's torch)."""
    fn = partial(ssd_reference, chunk=chunk)
    return ssd_on_mesh(fn, x, dt, a, b_mat, c_mat) if isinstance(x, DTensor) else fn(x, dt, a, b_mat, c_mat)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``, the counterpart of
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: keep the
    outputs of products with no batch dims (``mm``, and ``bmm`` over a batch
    of one, which is how ``einsum`` runs a weight product), recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, remat: str) -> Callable:
    """``fn`` under the activation checkpointing ``remat`` names, where
    autograd records (no grad: ``fn`` itself)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    policy = {} if remat == "full" else {
        "context_fn": partial(create_selective_checkpoint_contexts, _save_dots)}
    return partial(checkpoint, in_context(fn), use_reentrant=False, **policy)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; asking for CUDA
    where there is none raises (nothing drops to the CPU silently)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
class ParamTree(nn.Module):
    """A nested dict of tensors held as a module tree: dict keys become
    submodules or parameters, lists become ``ModuleList``s. Parameters
    need no gradient until a train state asks for one
    (``train.step.init_train_state``: ``requires_grad_(True)``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(x) for x in val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def map(self, fn: Callable[[str, torch.Tensor], torch.Tensor]) -> "ParamTree":
        """A tree of this type and structure holding ``fn(name, parameter)``
        for every parameter (``name`` as ``named_parameters()`` gives it),
        each keeping its parameter's ``requires_grad``."""
        def walk(node, prefix):
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}.{k}" if prefix else k) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v, f"{prefix}.{i}") for i, v in enumerate(node)]
            return fn(prefix, node)

        out = type(self)(walk(self.tree(), ""))
        want = dict(self.named_parameters())
        for name, p in out.named_parameters():
            p.requires_grad_(want[name].requires_grad)
        return out

    def tree(self) -> Dict[str, Any]:
        """The parameters back as a nested dict (the same tensors)."""
        out: Dict[str, Any] = dict(self._parameters)
        for key, mod in self._modules.items():
            out[key] = [m.tree() for m in mod] if isinstance(mod, nn.ModuleList) else mod.tree()
        return out


class Model(ParamTree):
    """The decoder's parameters: ``layers`` (per layer: ``norm1``, ``mixer``
    {``wq``, ``wk``, ``wv``, ``wo``[, ``q_norm``, ``k_norm``]}, ``norm2``,
    ``mlp`` {``wi_gate``[, ``wi_up``], ``wo``}), ``final_norm``, and
    ``embed`` and/or ``lm_head``. Matrices are (d_in, d_out), as in the
    reference."""

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None) -> Model:
    """Random weights with the reference's distributions: matrices normal ×
    1/√fan_in, the embedding normal × 0.02, the untied LM head normal /
    √d_model, norms zero, the Mamba-2 blocks as ``mamba2.mamba2_init`` and
    the MoE layers as ``moe.moe_init`` (the router f32); drawn in f32 from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA by
    default), then cast to ``dtype``. On the ``meta`` device the model has
    its shapes and dtypes and no data."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if dev.type != "meta" else "cpu").manual_seed(seed)

    def normal(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=gen, dtype=_F32, device=dev) * scale).to(dt)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    d, h, kh, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    layers = []
    for i in range(cfg.n_layers):
        if cfg.block_kinds[i % cfg.cycle_len] == "attn":
            mixer = {
                "wq": normal((d, h * dh), 1.0 / math.sqrt(d)),
                "wk": normal((d, kh * dh), 1.0 / math.sqrt(d)),
                "wv": normal((d, kh * dh), 1.0 / math.sqrt(d)),
                "wo": normal((h * dh, d), 1.0 / math.sqrt(h * dh)),
            }
            if cfg.qk_norm:
                mixer["q_norm"], mixer["k_norm"] = zeros(dh), zeros(dh)
        else:
            mixer = mamba2_init(normal, cfg, dtype, dev)
        layer = {"norm1": zeros(d), "mixer": mixer}
        mk = cfg.mlp_kind_at(i % cfg.cycle_len)
        if mk == "dense":
            mlp = {"wi_gate": normal((d, ff), 1.0 / math.sqrt(d)),
                   "wo": normal((ff, d), 1.0 / math.sqrt(ff))}
            if cfg.mlp_kind != "gelu":
                mlp["wi_up"] = normal((d, ff), 1.0 / math.sqrt(d))
            layer["norm2"], layer["mlp"] = zeros(d), mlp
        elif mk == "moe":
            layer["norm2"], layer["mlp"] = zeros(d), moe_init(normal, cfg, dtype, dev)
        layers.append(layer)
    tree: Dict[str, Any] = {"layers": layers, "final_norm": zeros(d)}
    if cfg.input_mode == "tokens":
        tree["embed"] = normal((cfg.vocab_size, d), 0.02)
    if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
        tree["lm_head"] = normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    return Model(tree)


def cast_params(params: Model, compute_dtype) -> Dict[str, Any]:
    """Mixed-precision policy, as the reference computes it: every f32
    tensor under ``layers`` (matrices, norm scales, the Mamba-2 conv bias and
    SSM scalars) computes in ``compute_dtype``, except the MoE router; the
    top-level tensors follow the rank rule, so f32 ``embed`` and ``lm_head``
    are cast and the 1-D ``final_norm`` keeps f32. (The reference's docstring
    keeps 1-D norm scales and SSM scalars in full precision, but it stacks
    every per-layer tensor over cycles before casting by rank, so all of
    them are at least 2-D there and are cast.) Returns the nested dict; a
    tensor already in its dtype is returned as is (no copy)."""

    def walk(node, name="", in_layers=False):
        if isinstance(node, dict):
            return {k: walk(v, k, in_layers or k == "layers") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, in_layers) for v in node]
        if "router" not in name and node.dtype == _F32 and (in_layers or node.dim() >= 2):
            return node.to(compute_dtype)
        return node

    return walk(params.tree())


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, norm: Callable, sequence: bool = False):
    """q, k, v (B, S, heads, Dh), q/k-normed; ``sequence`` pins them to the
    head layout, as the reference's sequence mode does (decode does not)."""
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv = ("batch", "seq", "act_kv_heads", "act_kv_dim")
    wk, wv = use_weight(p["wk"]), use_weight(p["wv"])
    project_kv = partial(_mm, "bsd,de->bse", x)
    if sequence and isinstance(wk, DTensor) and all(pl == Replicate() for pl in wk.placements):
        # KV weights whole on every device (a KV head count the model axis
        # does not divide): each model-axis device projects its share of
        # the sequence and the small K/V are gathered, rather than every
        # device projecting all of it (on the shards: act.local_product)
        x_kv = constrain(x, ("batch", "seq_res", "act_embed"))
        project_kv = partial(local_product, x_kv, fn=partial(_mm, "bsd,de->bse"))
    q = unflatten(_mm("bsd,de->bse", x, use_weight(p["wq"])), 2, (h, dh), ("batch", "seq", "act_heads", None))
    k = unflatten(project_kv(wk), 2, (kh, dh), kv)
    v = unflatten(project_kv(wv), 2, (kh, dh), kv)
    if sequence:
        q = constrain(q, ("batch", "seq", "act_heads", None))
        k = constrain(k, ("batch", "seq", "act_kv_heads", "act_kv_dim"))
        v = constrain(v, ("batch", "seq", "act_kv_heads", "act_kv_dim"))
    if cfg.qk_norm:
        q = norm(q, p["q_norm"], cfg.norm_eps)
        k = norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _position(q, k, cfg: ModelConfig, positions, mrope_positions):
    if cfg.rope_kind == "rope":
        return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
    if cfg.rope_kind == "mrope":
        mp = mrope_positions if mrope_positions is not None else positions[None].expand(3, *positions.shape)
        return (apply_mrope(q, mp, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, mp, cfg.rope_theta, cfg.mrope_sections))
    return q, k


def _attn_seq(p, x, cfg: ModelConfig, flags: RunFlags, positions, mrope_positions, want_cache: bool):
    s = x.shape[1]
    q, k, v = _qkv(p, x, cfg, norm_fn(flags), sequence=True)
    q, k = _position(q, k, cfg, positions, mrope_positions)
    impl = flags.attn_impl
    if impl == "auto":
        impl = "full" if s <= 1024 else "blockwise"
    if impl == "kernel":
        out = flash_attention(q, k, v, causal=True)  # on a mesh, on the shards as below
    else:
        if impl == "blockwise":
            fn = partial(flash_attention_ref, causal=True, q_block=min(flags.q_block, s),
                         kv_block=min(flags.kv_block, s))
        elif impl == "full":
            fn = partial(attention_full, causal=True)
        else:
            raise ValueError(f"unknown attn_impl {flags.attn_impl!r}")
        out = attention_on_shards(fn, q, k, v) if isinstance(q, DTensor) else fn(q, k, v)
    y = _mm("bse,ed->bsd", merge_heads(out), use_weight(p["wo"]))
    return y, ({"k": k, "v": v} if want_cache else None)


def _quantize(x: torch.Tensor):
    """int8 with a per-(token, head) absmax scale stored in bf16."""
    xf = x.to(_F32)
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale.to(torch.bfloat16)


def _attn_decode(p, x, cfg: ModelConfig, cache: dict, cur_index: int, mrope_positions,
                 norm: Callable):
    b, s, _ = x.shape  # s == 1
    q, k, v = _qkv(p, x, cfg, norm)
    positions = torch.full((b, 1), cur_index, dtype=torch.long, device=x.device)
    q, k = _position(q, k, cfg, positions, mrope_positions)
    if "k_scale" in cache:  # int8 KV cache (per-token, per-head absmax)
        for name, t in (("k", k), ("v", v)):
            tq, ts = _quantize(t)
            write_position(cache[name], cur_index, tq[:, 0])
            write_position(cache[f"{name}_scale"], cur_index, ts[:, 0])
        bf16 = torch.bfloat16
        k_cache = cache["k"].to(bf16) * cache["k_scale"].to(bf16)[..., None]
        v_cache = cache["v"].to(bf16) * cache["v_scale"].to(bf16)[..., None]
    else:
        write_position(cache["k"], cur_index, k[:, 0].to(cache["k"].dtype))
        write_position(cache["v"], cur_index, v[:, 0].to(cache["v"].dtype))
        k_cache, v_cache = cache["k"], cache["v"]
    out = attention_decode(q, k_cache, v_cache, cur_index)
    return _mm("bse,ed->bsd", merge_heads(out), use_weight(p["wo"]))


def _mlp(pos: int, p, x, cfg: ModelConfig, flags: RunFlags, norm: Callable, sequence: bool):
    """The channel mixer with its residual: (x, the MoE aux loss, or None
    where the position has no MoE layer). In ``sequence`` mode the mixer's
    input is pinned to the block layout, except on the shard_map MoE path,
    which places its own input (as in the reference)."""
    mk = cfg.mlp_kind_at(pos)
    if mk not in ("dense", "moe"):
        return x, None
    h2, aux = norm(x, p["norm2"], cfg.norm_eps), None
    if mk == "moe" and _shard_map_moe(flags, cfg) and sequence:
        rules, mesh = current_context()
        y, aux = moe_apply_shard_map(p["mlp"], h2, cfg, mesh, rules)
    else:
        if sequence:
            h2 = constrain(h2, ("batch", None, "act_embed"))
        if mk == "dense":
            y = mlp_apply(p["mlp"], h2, cfg.mlp_kind)
        else:
            y, aux = moe_apply(p["mlp"], h2, cfg)
    return _residual(x, y, sequence), aux


def _residual(x, h, sequence: bool):
    """x + h. In ``sequence`` mode h first takes the residual stream's
    layout (Megatron-SP's reduce-scatter at the add), so its gradient comes
    back in h's own layout: the products behind h flatten (B, S) in their
    backward, which a sequence-sharded gradient cannot take as a view."""
    if sequence:
        h = constrain(h, ("batch", "seq_res", "act_embed"))
    return x + h


def _block_seq(pos: int, p, x, cfg: ModelConfig, flags: RunFlags, positions, mrope_positions,
               want_cache: bool):
    """One layer over the sequence: (x, its decode cache or None, its MoE
    aux loss or None). A Mamba-2 layer's cache comes from
    ``mamba2_prefill``, which takes the final SSM state from the layer's one
    SSD call (the reference's ``_mamba_prefill_cache`` recomputes it)."""
    norm = norm_fn(flags)
    # the block input at full sequence: the residual stream may be
    # sequence-sharded between blocks (the seq_res rule)
    normed = constrain(norm(x, p["norm1"], cfg.norm_eps), ("batch", None, "act_embed"))
    if cfg.block_kinds[pos] == "attn":
        h, cache = _attn_seq(p["mixer"], normed, cfg, flags, positions, mrope_positions, want_cache)
    else:
        h, cache = mamba2_prefill(p["mixer"], normed, cfg, _ssd_fn(flags, x.shape[1]), norm)
        cache = cache if want_cache else None
    x, aux = _mlp(pos, p, _residual(x, h, True), cfg, flags, norm, sequence=True)
    return x, cache, aux


def _block_decode(pos: int, p, x, cfg: ModelConfig, cache: dict, cur_index: int, mrope_positions,
                  flags: RunFlags):
    """One layer on one token; the MoE aux loss is dropped, as in the
    reference."""
    norm = norm_fn(flags)
    h = norm(x, p["norm1"], cfg.norm_eps)
    if cfg.block_kinds[pos] == "attn":
        h = _attn_decode(p["mixer"], h, cfg, cache, cur_index, mrope_positions, norm)
    else:
        h, _ = mamba2_decode(p["mixer"], h, cache, cfg, norm)
    return _mlp(pos, p, x + h, cfg, flags, norm, sequence=False)[0]


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
HEAD_USE = ("embed", "act_vocab")  # the LM head matrix (D, V) at its product


def _embed(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor], compute_dtype) -> torch.Tensor:
    # an embedding lookup, the reference's gather: DTensor shards it (and
    # its backward) where a sharded index into a table trips the card's
    # torch. On a mesh the table is whole over the data axes, so the rows
    # come out batch-sharded as the tokens are
    if cfg.input_mode == "tokens":
        x = F.embedding(batch["tokens"], use_weight(p["embed"], ("vocab_table", "embed")))
    else:
        x = batch["embeds"]
    x = x.to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype, device=x.device)
    return x


def _head(p, cfg: ModelConfig, x: torch.Tensor, norm: Callable = rms_norm) -> torch.Tensor:
    x = norm(x, p["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings and "embed" in p:
        w = p["embed"].t().to(x.dtype)
    else:
        w = p["lm_head"].to(x.dtype)
    # the reference's bf16 product with f32 accumulation and f32 logits: the
    # operands widen to f32 exactly, so only the summation order differs
    w = use_weight(w, HEAD_USE)
    return constrain(torch.matmul(x.to(_F32), w.to(_F32)), ("batch", "seq", "act_vocab"))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def _sequence(p, cfg: ModelConfig, batch, flags: RunFlags, compute_dtype, want_cache: bool):
    """Embed and run every layer: (hidden pre-final-norm, per-layer caches,
    the MoE aux loss summed over layers in order, f32). Under autograd each
    cycle (``cfg.cycle_len`` layers) is one unit of ``flags.remat``, the aux
    one of its outputs; caches come only from runs without it."""
    x = _embed(p, cfg, batch, compute_dtype)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    mrope_positions = batch.get("mrope_positions")
    x = constrain(x, ("batch", "seq_res", "act_embed"))

    def cycle_body(x, aux, layers):
        caches = []
        for pos, lp in enumerate(layers):
            x, cache, a = _block_seq(pos, lp, x, cfg, flags, positions, mrope_positions, want_cache)
            x = constrain(x, ("batch", "seq_res", "act_embed"))
            caches.append(cache)
            if a is not None:  # the reference adds an exact 0 for the other layers
                aux = aux + a
        return x, aux, caches

    body = _remat(cycle_body, "none" if want_cache else flags.remat)
    cl, caches = cfg.cycle_len, []
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for c in range(0, len(p["layers"]), cl):
        x, aux, cycle_caches = body(x, aux, p["layers"][c:c + cl])
        caches += cycle_caches
    return x, (caches if want_cache else None), aux


def forward(
    params: Model,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    flags: RunFlags = RunFlags(),
    compute_dtype=torch.bfloat16,
    want_cache: bool = False,
):
    """Sequence-mode forward: returns (logits f32, aux, per-layer cache or
    None). ``aux`` is the MoE load-balancing loss summed over the MoE
    layers (0 for the other stacks)."""
    p = cast_params(params, compute_dtype)
    x, caches, aux = _sequence(p, cfg, batch, flags, compute_dtype, want_cache)
    return _head(p, cfg, x, norm_fn(flags)), aux, caches


def forward_hidden(
    params: Model,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    flags: RunFlags = RunFlags(),
    compute_dtype=torch.bfloat16,
):
    """Forward without the LM head: (hidden (B, S, D) after the final norm,
    aux)."""
    p = cast_params(params, compute_dtype)
    x, _, aux = _sequence(p, cfg, batch, flags, compute_dtype, False)
    return norm_fn(flags)(x, p["final_norm"], cfg.norm_eps), aux


def head_matrix(params: Model, cfg: ModelConfig, compute_dtype=torch.bfloat16) -> torch.Tensor:
    p = cast_params(params, compute_dtype)
    if cfg.tie_embeddings and "embed" in p:
        return p["embed"].t().to(compute_dtype)
    return p["lm_head"].to(compute_dtype)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
               kv_quant: str = "none", device=None) -> List[dict]:
    """Decode cache: one dict per layer. An attention layer holds its KV
    ({"k", "v"} (B, cache_len, KH, Dh) in ``dtype``; ``kv_quant='int8'``
    stores int8 with a per-(token, head) absmax scale in bf16); a Mamba-2
    layer holds {"conv": (B, W-1, conv_dim) in ``dtype``, "ssm": (B, H, P,
    N) f32}, whatever ``cache_len``."""
    if kv_quant not in ("none", "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    dev = resolve_device(device)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    caches = []
    for i in range(cfg.n_layers):
        if cfg.block_kinds[i % cfg.cycle_len] != "attn":
            caches.append(mamba2_cache_init(cfg, batch, dtype, dev))
        elif kv_quant == "int8":
            caches.append({
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev),
            })
        else:
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
    return caches


def decode_step(
    params: Model,
    cfg: ModelConfig,
    cache: List[dict],
    batch: Dict[str, torch.Tensor],
    cur_index: int,
    flags: RunFlags = RunFlags(),
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, List[dict]]:
    """One new token against the cache at position ``cur_index``. Returns
    (logits (B, 1, V) f32, cache); the cache is updated in place and the
    same list is returned. Of ``flags`` only ``norm_impl`` and ``moe_impl``
    apply: decode attention and the one-token SSD update are plain torch,
    as in the reference. On a mesh the weights stay on their FSDP shards
    (``sharding.act.weights_as_placed``)."""
    with weights_as_placed():
        p = cast_params(params, compute_dtype)
        x = _embed(p, cfg, batch, compute_dtype)
        mrope_positions = batch.get("mrope_positions")
        for i, lp in enumerate(p["layers"]):
            x = _block_decode(i % cfg.cycle_len, lp, x, cfg, cache[i], cur_index, mrope_positions, flags)
        return _head(p, cfg, x, norm_fn(flags)), cache
