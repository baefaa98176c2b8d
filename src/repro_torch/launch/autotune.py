"""FARSI-style auto-configuration of the distributed execution
(the paper's technique as a first-class framework feature); the port's copy
of the reference's ``repro.launch.autotune``, driven by the same seeded
``random`` stream. Pure host code over a model of a TPU v5e pod.

Design space = DistConfig: sharding rules (mapping — *migrate*), ladder knobs
(microbatches, attention/SSD block sizes, remat, kernel on/off —
customization — *swap*). The explorer is the paper's loop: pick the metric
farthest from budget, attribute it to the costliest op (task) and its
binding resource (block ∈ {MXU, HBM, ICI}), choose moves by architectural
reasoning, keep SA temperature for escapes. The cost oracle is the agile
FARSI phase-sim over the step TDG (core/tpu_design.py).

Budgets: step latency (performance), energy/step (power proxy), HBM bytes
(area analog: the modelled TPU chip's 16 GB).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..core.tpu_design import simulate_step
from ..roofline.analytic import MeshShape
from ..sharding.rules import DistConfig

TPU_V5E_HBM_CAPACITY = 16e9  # the modelled TPU chip's HBM
E_PJ_PER_FLOP = 0.6
E_PJ_PER_HBM_BYTE = 12.0
E_PJ_PER_ICI_BYTE = 4.0

MICRO_LADDER = (1, 2, 4, 8, 16, 32)
QBLOCK_LADDER = (128, 256, 512, 1024)
SSD_LADDER = (32, 64, 128, 256)


@dataclasses.dataclass
class TuneRecord:
    iteration: int
    move: str
    knob: str
    hypothesis: str
    before: Dict[str, float]
    after: Dict[str, float]
    accepted: bool


def estimate(cfg, shape, mesh, dist) -> Dict[str, float]:
    t = simulate_step(cfg, shape, mesh, dist)
    e = (
        t["flops"] * E_PJ_PER_FLOP
        + t["hbm_bytes"] * E_PJ_PER_HBM_BYTE
        + t["ici_bytes"] * E_PJ_PER_ICI_BYTE
    ) * 1e-12
    t["energy_j"] = e
    t["hbm_state_bytes"] = _state_bytes(cfg, shape, mesh, dist)
    return t


def _state_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape, dist) -> float:
    # with TP off, weights/opt-state replicate across the model axis and can
    # only shard over data — 123B-class models become infeasible (the reason
    # the tuner must not pick tp_off for them)
    tp = dist.rules.get("qkv", ("model",)) is not None
    p = cfg.param_counts()["total"] / (mesh.chips if tp else mesh.data)
    if shape.kind == "train":
        state = p * (4 * 3)  # fp32 params + m + v, fully sharded
        tok_dev = shape.global_batch * shape.seq_len / mesh.data / max(dist.microbatches, 1)
        sp = mesh.model if dist.rules.get("seq_res") else 1
        stack = cfg.n_layers * tok_dev * cfg.d_model * 6 / sp  # bf16 + f32 copies
        if dist.remat == "none":
            # no remat saves every per-layer intermediate, not just the
            # residual carry: ≈ (4·d + 2·d_ff)/d wider (the compile-refuted
            # qwen3-moe lesson, baked into the model)
            widen = 4 + 2 * max(cfg.d_ff, cfg.moe_d_ff * min(cfg.top_k, 1) if cfg.n_experts else 0) / cfg.d_model
            stack *= widen
        return state + stack
    state = p * 2  # bf16 weights
    if shape.kind == "decode" and cfg.has_attention():
        n_attn = sum(1 for k in cfg.block_kinds if k == "attn") * cfg.n_cycles
        kv_b = (1.0 + 2.0 / cfg.head_dim) if dist.kv_quant == "int8" else 2.0
        cache = (
            shape.global_batch
            * shape.seq_len
            * cfg.n_kv_heads
            * cfg.head_dim
            * kv_b
            * 2
            * n_attn
            / mesh.chips
        )
        state += cache * 2  # + in-flight copy
    return state


# ---------------------------------------------------------------------------
# moves over DistConfig
# ---------------------------------------------------------------------------
def _ladder_step(ladder, cur, direction):
    i = ladder.index(cur) + direction
    return ladder[i] if 0 <= i < len(ladder) else None


def moves_for(dominant: str, shape: ShapeConfig, cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Algorithm-1 analog: (move, knob) candidates that can relax the
    dominant roofline term, ordered by development-cost precedence
    (mapping flips before kernel/knob customization)."""
    out: List[Tuple[str, str]] = []
    if dominant == "collective":
        # migrate: move weight sharding off the model axis (TP→DP) — kills
        # per-layer boundary collectives at the price of replicated weights
        out += [("migrate", "tp_off"), ("swap", "ring_bidir"), ("migrate", "seq_res_off")]
        if cfg.has_moe():
            out += [("swap", "a2a_int8"), ("swap", "cf_down")]
        if shape.kind == "train":
            out += [("swap", "grad_int8"), ("swap", "remat_none"), ("swap", "micro_down")]
    elif dominant == "memory":
        if shape.kind == "decode":
            out += [("swap", "kv_int8")]
        if shape.kind == "train":
            out += [("swap", "micro_up"), ("migrate", "seq_res_on"), ("swap", "remat_full")]
        out += [("migrate", "tp_on")]
    else:  # compute
        out += [("swap", "kernel_attn")]
        if shape.kind == "train":
            out += [("swap", "remat_none"), ("swap", "micro_down")]
        out += [("swap", "ssd_up")]
    return out


def apply_move(dist: DistConfig, knob: str) -> Optional[Tuple[DistConfig, str]]:
    """Returns (new DistConfig, hypothesis text) or None if inapplicable."""
    r = dict(dist.rules)
    if knob == "tp_off":
        if r.get("qkv") is None:
            return None
        for k in ("qkv", "kv_qkv", "mlp", "ssm_inner", "ssm_conv", "expert_mlp"):
            r[k] = None
        return dist.replace(rules=r), (
            "weights replicated over model axis → per-layer TP boundary "
            "collectives vanish; HBM weight traffic × model-axis"
        )
    if knob == "tp_on":
        if r.get("qkv") is not None:
            return None
        for k in ("qkv", "kv_qkv", "mlp", "ssm_inner", "ssm_conv", "expert_mlp"):
            r[k] = ("model",)
        return dist.replace(rules=r), "re-enable TP: weight HBM traffic ÷ model-axis"
    if knob == "seq_res_off":
        if r.get("seq_res") is None:
            return None
        r["seq_res"] = None
        return dist.replace(rules=r), "drop SP: removes ag/rs at block edges, grows act stack"
    if knob == "seq_res_on":
        if r.get("seq_res") is not None:
            return None
        r["seq_res"] = ("model",)
        return dist.replace(rules=r), "enable SP: remat stack ÷ model-axis"
    if knob == "micro_up":
        n = _ladder_step(MICRO_LADDER, dist.microbatches, +1)
        if n is None:
            return None
        return dist.replace(microbatches=n), "more grad-accum: activation stack ÷ 2"
    if knob == "micro_down":
        n = _ladder_step(MICRO_LADDER, dist.microbatches, -1)
        if n is None:
            return None
        return dist.replace(microbatches=n), "less grad-accum: fewer weight re-reads/collective replays"
    if knob == "kernel_attn":
        if dist.attn_impl == "kernel":
            return None
        return dist.replace(attn_impl="kernel"), (
            "Pallas flash kernel: causal block-skip halves attention FLOPs"
        )
    if knob == "remat_none":
        if dist.remat == "none":
            return None
        return dist.replace(remat="none"), "no remat: −1× forward recompute, +stack memory"
    if knob == "remat_full":
        if dist.remat == "full":
            return None
        return dist.replace(remat="full"), "full remat: stack ÷ L, +1× forward"
    if knob == "ssd_up":
        n = _ladder_step(SSD_LADDER, dist.ssd_chunk, +1)
        if n is None:
            return None
        return dist.replace(ssd_chunk=n), "larger SSD chunk: better MXU shapes, fewer state hops"
    if knob == "kv_int8":
        if dist.kv_quant == "int8":
            return None
        return dist.replace(kv_quant="int8"), (
            "int8 KV cache (per-token/head absmax): cache bytes ≈ ÷1.9 — the "
            "decode step is a cache-read roofline, so t_memory ≈ ÷1.9"
        )
    if knob == "a2a_int8":
        if dist.a2a_bytes == 1:
            return None
        return dist.replace(a2a_bytes=1), (
            "int8 MoE dispatch payload: all-to-all bytes ÷2 (combine in bf16 "
            "upcast on arrival)"
        )
    if knob == "grad_int8":
        if dist.grad_compress == "int8":
            return None
        return dist.replace(grad_compress="int8"), (
            "error-feedback int8 gradient reduce-scatter: DP sync bytes ÷4"
        )
    if knob == "ring_bidir":
        if dist.ici_links >= 2:
            return None
        return dist.replace(ici_links=2), (
            "bidirectional-ring collective schedule: both torus directions "
            "carry the all-reduce/all-gather concurrently → boundary "
            "collective time ÷2 (XLA does this on real ICI; our baseline "
            "models the pessimistic single-direction ring)"
        )
    if knob == "cf_down":
        if 0 < dist.capacity_factor <= 1.0:
            return None
        return dist.replace(capacity_factor=1.0), (
            "MoE capacity factor 1.25→1.0: dispatch volume (a2a bytes AND "
            "expert FLOPs) ×0.8, at the cost of more dropped tokens"
        )
    return None


@dataclasses.dataclass
class TuneResult:
    best: DistConfig
    best_terms: Dict[str, float]
    baseline_terms: Dict[str, float]
    log: List[TuneRecord]


def autotune(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: MeshShape,
    dist0: DistConfig,
    iterations: int = 30,
    seed: int = 0,
    hbm_budget: float = TPU_V5E_HBM_CAPACITY,
) -> TuneResult:
    rng = random.Random(seed)
    cur = dist0
    cur_t = estimate(cfg, shape, mesh, cur)
    base_t = dict(cur_t)
    best, best_t = cur, cur_t
    log: List[TuneRecord] = []

    def score(t):  # latency with a hard HBM-capacity wall
        penalty = max(0.0, (t["hbm_state_bytes"] - hbm_budget) / hbm_budget) * 10
        return t["t_phase_sim_s"] * (1 + penalty)

    for it in range(iterations):
        dom = cur_t["dominant"]
        if cur_t["hbm_state_bytes"] > hbm_budget:
            dom = "memory"
        cands = moves_for(dom, shape, cfg)
        rng.shuffle(cands)
        # dev-cost precedence: mapping (migrate) before customization (swap)
        cands.sort(key=lambda mk: 0 if mk[0] == "migrate" else 1)
        progressed = False
        for move, knob in cands:
            applied = apply_move(cur, knob)
            if applied is None:
                continue
            cand, hypothesis = applied
            cand_t = estimate(cfg, shape, mesh, cand)
            accept = score(cand_t) < score(cur_t) or rng.random() < 0.05 * (0.9**it)
            log.append(
                TuneRecord(
                    it, move, knob, hypothesis,
                    {k: cur_t[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "t_phase_sim_s", "hbm_state_bytes")},
                    {k: cand_t[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "t_phase_sim_s", "hbm_state_bytes")},
                    accept,
                )
            )
            if accept:
                cur, cur_t = cand, cand_t
                if score(cur_t) < score(best_t):
                    best, best_t = cur, cur_t
                progressed = True
                break
        if not progressed:
            break
    return TuneResult(best=best, best_terms=best_t, baseline_terms=base_t, log=log)
