"""Analytic per-device roofline accounting for one (arch × shape × mesh ×
DistConfig) cell: the port's copy of the reference's
``repro.roofline.analytic``, the same formulas in the same order.

This is a model of a step on a TPU v5e pod, not of the port on its card.
The hardware constants below are the modelled TPU chip's (named
``TPU_V5E_*``) and are inputs to that model, kept at the reference's values
so that every term agrees with it; none is a rate of the port.

Three terms per device:

  compute    = device_FLOPs / TPU_V5E_PEAK_FLOPS       (bf16 matrix peak)
  memory     = device_HBM_bytes / TPU_V5E_HBM_BW
  collective = device_ICI_bytes / (TPU_V5E_ICI_BW_PER_LINK per link)

Every op is accounted with an explicit formula (each op also becomes a task
in the FARSI step-TDG, core/tpu_design.py).

All numbers are per device, per step. Conventions:
 * matmul FLOPs = 2·M·N·K; backward = 2× forward; remat="full" re-runs the
   forward inside backward (+1×).
 * the blockwise/flash attention reference computes the full S² extent and
   masks (static trip counts); the kernel skips fully-masked blocks.
   Both are reported: MODEL_FLOPS / executed FLOPs exposes the difference.
 * collectives: ring cost (n-1)/n ≈ 1 per hop omitted; all-reduce counts 2×
   payload (reduce-scatter + all-gather).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..configs.base import ModelConfig, ShapeConfig
from ..sharding.rules import DistConfig

# the modelled TPU v5e chip and pod (inputs of the model, not the port's rates)
TPU_V5E_PEAK_FLOPS = 197e12  # bf16 per chip
TPU_V5E_HBM_BW = 819e9  # bytes/s per chip
TPU_V5E_ICI_BW_PER_LINK = 50e9  # bytes/s per link
ICI_LINKS = 1  # conservative single-link baseline (an autotuner knob)
# inter-pod (data-center) links: slower and fewer than intra-pod ICI — only
# the 'pod'-axis share of the gradient reduction crosses them
TPU_V5E_DCI_BW = 25e9  # bytes/s per inter-pod link
DCI_LINKS_PER_POD = 8

BF16 = 2
FP32 = 4


@dataclasses.dataclass
class OpCost:
    """One step-graph op, per device."""

    name: str
    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    deps: tuple = ()


@dataclasses.dataclass
class MeshShape:
    data: int  # product of ('pod', 'data')
    model: int
    pods: int = 1  # how many pods the data product spans

    @property
    def chips(self) -> int:
        return self.data * self.model


def interpod_term(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape, dist=None) -> float:
    """Seconds of inter-pod traffic per step: with batch over ('pod','data'),
    only the gradient reduction crosses pods — each pod exchanges its full
    (model-sharded) gradient partial once over the DCI links (ring over
    pods). Serving shapes cross nothing (requests are pod-local)."""
    if mesh.pods <= 1 or shape.kind != "train":
        return 0.0
    grad_b = 1.0 if (dist and dist.grad_compress == "int8") else FP32
    per_pod_bytes = cfg.param_counts()["total"] / mesh.model * grad_b
    ring = 2 * (mesh.pods - 1) / mesh.pods
    return per_pod_bytes * ring / (TPU_V5E_DCI_BW * DCI_LINKS_PER_POD)


def _bwd_mult(kind: str, remat: str) -> float:
    """Total (fwd+bwd[+remat]) multiplier over forward FLOPs."""
    base = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[kind]
    if kind == "train" and remat == "full":
        base += 1.0
    return base


def step_costs(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: MeshShape,
    dist: Optional[DistConfig] = None,
) -> List[OpCost]:
    remat = dist.remat if dist else "full"
    kernel_attn = bool(dist and dist.attn_impl == "kernel")
    d, hq, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kind = shape.kind
    mult = _bwd_mult(kind, remat)
    chips = mesh.chips
    # TP on/off comes from the sharding rules (the autotuner's migrate knob):
    # with TP off the model axis becomes extra data parallelism — weights are
    # replicated (×model HBM traffic) but per-layer boundary collectives vanish.
    tp = True if dist is None else (dist.rules.get("qkv", ("model",)) is not None)
    n_model_w = mesh.model if tp else 1
    kv_sharded = tp and kh > 0 and kh % mesh.model == 0

    b, s = shape.global_batch, shape.seq_len
    tokens = b * (1 if kind == "decode" else s)
    t_dev = tokens / mesh.data / (1 if kind != "decode" else 1)
    # tokens are replicated across the model axis (TP splits the *work*)
    ops: List[OpCost] = []

    wbytes = BF16  # weights are consumed in bf16
    abytes = BF16

    def add(name, flops_g=0.0, hbm=0.0, ici=0.0, deps=()):
        ops.append(OpCost(name, flops_g, hbm, ici, deps))

    # ---- embedding ------------------------------------------------------
    if cfg.input_mode == "tokens":
        add(
            "embed",
            flops_g=0.0,
            hbm=t_dev * d * abytes + t_dev * 4,  # activation write + token read
        )
    else:
        add("embed", hbm=t_dev * d * abytes * 2)

    # ---- per cycle-position ops ------------------------------------------
    seq_len_ctx = shape.seq_len  # kv extent for decode
    prev = "embed"
    for pos, kindb in enumerate(cfg.block_kinds):
        tag = f"L{pos}"
        n_rep = cfg.n_cycles
        if kindb == "attn":
            # qkv + out projections
            q_flops = 2 * tokens * d * hq * dh
            kv_rep = mesh.model if (tp and not kv_sharded) else 1  # replicated kv compute
            kv_flops = 2 * tokens * d * kh * dh * 2 * kv_rep
            o_flops = 2 * tokens * hq * dh * d
            proj_flops = (q_flops + kv_flops + o_flops) * mult / chips
            w_proj = (d * hq * dh + hq * dh * d) / n_model_w + 2 * d * kh * dh / (
                n_model_w if kv_sharded else 1
            )
            reads = mult if kind == "train" else 1
            add(
                f"{tag}.attn_proj",
                flops_g=n_rep * proj_flops,
                hbm=n_rep
                * (w_proj * wbytes * reads * (dist.microbatches if dist and kind == "train" else 1)
                   + t_dev * d * abytes * 2 * mult),
                deps=(prev,),
            )
            # attention core
            if kind == "decode":
                core = 2 * b * hq * dh * seq_len_ctx * 2  # qk + pv over cache
                # cache sharded over (batch×data, heads-or-dh×model): full read
                kv_b = (
                    1.0 + 2.0 / dh  # int8 payload + bf16 scale per (tok, head)
                    if (dist and dist.kv_quant == "int8")
                    else BF16
                )
                cache_rd = b * seq_len_ctx * kh * dh * 2 * kv_b / chips
                add(
                    f"{tag}.attn_core",
                    flops_g=n_rep * core / chips,
                    hbm=n_rep * cache_rd,
                    deps=(f"{tag}.attn_proj",),
                )
            else:
                full = 4 * b * s * s * hq * dh  # qk^T + pv, full extent
                causal = full / 2
                executed = causal if kernel_attn else full
                # flash bwd ≈ 2.5× fwd (5 block matmuls vs 2): total fwd+bwd
                # (+remat fwd) = mult + 0.5 in units of fwd
                attn_mult = (mult + 0.5) if kind == "train" else mult
                add(
                    f"{tag}.attn_core",
                    flops_g=n_rep * executed * attn_mult / chips,
                    hbm=n_rep * t_dev * hq * dh * abytes * 2 * mult,
                    deps=(f"{tag}.attn_proj",),
                )
            # TP boundary collectives (SP: ag+rs ≈ all-reduce payload)
            tp_bytes = 2 * t_dev * d * abytes * mult if (tp and mesh.model > 1) else 0.0
            add(f"{tag}.attn_tp", ici=n_rep * tp_bytes, deps=(f"{tag}.attn_core",))
            prev_mixer = f"{tag}.attn_tp"
        else:  # mamba2 (SSD)
            d_in = cfg.ssm_d_inner
            nh_ss = cfg.ssm_n_heads
            n_ss = cfg.ssm_state
            p_ss = cfg.ssm_head_dim
            proj = 2 * tokens * d * (2 * d_in + 2 * n_ss + nh_ss) + 2 * tokens * d_in * d
            if kind == "decode":
                ssd = 2 * b * (d_in * n_ss * 2)  # state update + emit
            else:
                q_chunk = dist.ssd_chunk if dist else 64
                per_tok_head = 2 * q_chunk * p_ss + 4 * p_ss * n_ss
                ssd = tokens * nh_ss * per_tok_head + tokens * 2 * q_chunk * n_ss
            state_bytes = b * nh_ss * p_ss * n_ss * FP32 / chips if kind == "decode" else 0
            add(
                f"{tag}.ssm",
                flops_g=n_rep * (proj + ssd) * mult / chips,
                hbm=n_rep
                * (
                    (d * (2 * d_in + 2 * n_ss + nh_ss) + d_in * d)
                    / n_model_w
                    * wbytes
                    * (mult if kind == "train" else 1)
                    * (dist.microbatches if dist and kind == "train" else 1)
                    + t_dev * d * abytes * 2 * mult
                    + state_bytes
                ),
                deps=(prev,),
            )
            tp_bytes = 2 * t_dev * d * abytes * mult if (tp and mesh.model > 1) else 0.0
            add(f"{tag}.ssm_tp", ici=n_rep * tp_bytes, deps=(f"{tag}.ssm",))
            prev_mixer = f"{tag}.ssm_tp"

        mk = cfg.mlp_kind_at(pos)
        if mk == "dense":
            n_mats = 2 if cfg.mlp_kind == "gelu" else 3
            f_flops = n_mats * 2 * tokens * d * cfg.d_ff
            add(
                f"{tag}.mlp",
                flops_g=n_rep * f_flops * mult / chips,
                hbm=n_rep
                * (
                    n_mats * d * cfg.d_ff / n_model_w * wbytes
                    * (mult if kind == "train" else 1)
                    * (dist.microbatches if dist and kind == "train" else 1)
                    + t_dev * d * abytes * 2 * mult
                ),
                deps=(prev_mixer,),
            )
            tp_b = 2 * t_dev * d * abytes * mult if (tp and mesh.model > 1) else 0.0
            add(f"{tag}.mlp_tp", ici=n_rep * tp_b, deps=(f"{tag}.mlp",))
            prev = f"{tag}.mlp_tp"
        elif mk == "moe":
            fe = cfg.moe_d_ff or cfg.d_ff
            cf = (dist.capacity_factor if dist and dist.capacity_factor > 0 else cfg.capacity_factor)
            disp = tokens * cfg.top_k * cf
            r_flops = 2 * tokens * d * cfg.n_experts
            e_flops = 3 * 2 * disp * d * fe
            ep = cfg.n_experts % mesh.model == 0  # EP vs expert-TP (independent of TP)
            w_moe = cfg.n_experts * 3 * d * fe / (mesh.model if (ep or tp) else 1)
            # dispatched activations live sequence/batch-sharded over ALL
            # chips (SP keeps the residual stream model-sharded too), so
            # per-device dispatch traffic divides by chips, not just data
            a2a_quant = getattr(dist, "a2a_bytes", BF16) if dist else BF16
            add(
                f"{tag}.moe",
                flops_g=n_rep * (r_flops + e_flops) * mult / chips,
                hbm=n_rep
                * (
                    w_moe * wbytes * (mult if kind == "train" else 1)
                    * (dist.microbatches if dist and kind == "train" else 1)
                    + (disp / chips) * d * abytes * 2 * mult
                ),
                deps=(prev_mixer,),
            )
            # EP all-to-all (dispatch+combine); expert-TP pays TP all-reduce
            if ep:
                a2a = 2 * (disp / chips) * d * a2a_quant * mult
            elif tp:
                a2a = 2 * t_dev * d * abytes * mult
            else:
                a2a = 0.0
            add(f"{tag}.moe_a2a", ici=n_rep * a2a, deps=(f"{tag}.moe",))
            prev = f"{tag}.moe_a2a"
        else:
            prev = prev_mixer

    # ---- head + loss ------------------------------------------------------
    head_tokens = tokens if kind == "train" else b
    h_flops = 2 * head_tokens * d * cfg.vocab_size * (mult if kind == "train" else 1)
    add(
        "head",
        flops_g=h_flops / chips,
        hbm=d * cfg.vocab_size / mesh.model * wbytes
        + head_tokens / mesh.data * cfg.vocab_size * FP32 / mesh.model,
        deps=(prev,),
    )

    # ---- optimizer + gradient sync (train only) ----------------------------
    if kind == "train":
        p_total = cfg.param_counts()["total"]
        p_local = p_total / chips  # fully sharded state (TP×FSDP)
        add(
            "optimizer",
            flops_g=p_local * 12,
            hbm=p_local * (FP32 * 3 * 2 + FP32),  # p,m,v read+write, grad read
            deps=("head",),
        )
        # FSDP weight all-gather (bf16, fwd+bwd) + grad reduce-scatter
        # (fp32, or int8+scale with error-feedback compression)
        fsdp = mesh.data > 1
        grad_b = 1.0 if (dist and dist.grad_compress == "int8") else FP32
        ag = 2 * p_total / chips * BF16 if fsdp else 0.0
        rs = p_total / chips * grad_b * (1 if fsdp else 2)
        add("grad_sync", ici=ag + rs, deps=("head",))

    return ops


def roofline_terms(ops: List[OpCost], ici_links: int = ICI_LINKS) -> Dict[str, float]:
    f = sum(o.flops for o in ops)
    h = sum(o.hbm_bytes for o in ops)
    c = sum(o.ici_bytes for o in ops)
    t_f = f / TPU_V5E_PEAK_FLOPS
    t_h = h / TPU_V5E_HBM_BW
    t_c = c / (TPU_V5E_ICI_BW_PER_LINK * ici_links)
    dom = max(("compute", t_f), ("memory", t_h), ("collective", t_c), key=lambda kv: kv[1])
    return {
        "flops": f,
        "hbm_bytes": h,
        "ici_bytes": c,
        "t_compute_s": t_f,
        "t_memory_s": t_h,
        "t_collective_s": t_c,
        "t_roofline_s": max(t_f, t_h, t_c),
        "dominant": dom[0],
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (dense/MoE; +causal attention term).
    The 'useful work' yardstick: the FLOPs a step needs, whatever runs
    them (``chip_smoke.py`` divides it by the card's own peak)."""
    n_active = cfg.param_counts()["active"]
    if shape.kind == "decode":
        tokens = shape.global_batch
        per_tok = 2 * n_active
        attn = 0.0
        if cfg.has_attention():
            n_attn = sum(1 for k in cfg.block_kinds if k == "attn") * cfg.n_cycles
            attn = 4 * tokens * cfg.n_heads * cfg.head_dim * shape.seq_len * n_attn / 2
        return per_tok * tokens + attn
    tokens = shape.global_batch * shape.seq_len
    mult = 6 if shape.kind == "train" else 2  # 2·N fwd (+4·N bwd) per token
    base = mult * n_active * tokens
    attn = 0.0
    if cfg.has_attention():
        n_attn = sum(1 for k in cfg.block_kinds if k == "attn") * cfg.n_cycles
        # causal qk^T+pv = 4·B·S²·H·Dh / 2 forward; ×(mult/2) for bwd
        attn = (
            (mult / 2)
            * 4
            * shape.global_batch
            * shape.seq_len**2
            * cfg.n_heads
            * cfg.head_dim
            * n_attn
            / 2
        )
    return base + attn
