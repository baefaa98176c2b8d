"""Device-resident exploration: the fused accept loop over chain populations.

The host-driven accept loop pays, every SA iteration, a dispatch, a copy of
the fitness back to the host and a Python accept/taboo update before the
next candidate can be proposed. This module keeps the whole explore step on
the device:

  * :class:`MoveTable` — ``propose_moves`` in packed array form. Every
    candidate move is enumerated up front as three flat int32 columns
    (``kind``/``arg``/``dest``); the loop *samples* a row of this table on
    the device. Beyond the mapping moves (task → PE/MEM slot migrates), the
    ``alloc`` table adds FARSI's allocation moves as shape-preserving
    operations over *capacity-padded slot inventories*: PE/MEM fork (clone a
    slot's coefficient columns into an inactive slot and re-home one task),
    join (deactivate an emptied slot: its leak and area stop pricing through
    the active masks), swap (step the slot's frequency rung, scaling its
    closed-form coefficient columns by static ladder ratios) and NoC attach
    (re-home a slot to another chain position). Validity is masked per chain
    from the carry: join only an empty slot, fork only into an inactive slot
    and only off a slot hosting ≥ 2 tasks, swap only inside the ladder.
  * The block: K iterations of sample → apply → re-price → SA accept for R
    chains, a Python loop of torch ops with no host synchronisation inside
    it. Every iteration prices the R mutated platforms in one call of the
    phase-sim kernel (``kernels.phase_sim.chain.resimulate_chains``), so a
    block on the card is K kernel launches. The carry (:class:`ChainCarry`)
    holds the full per-chain platform state: task→slot maps, active-slot
    masks, per-slot coefficient columns, frequency rungs, fork provenance,
    the (T, cap) acceleration table, fitness, threefry key, per-move taboo
    TTLs and the incumbent bottleneck telemetry.
  * Chain populations: the R chains are the batch axis of the simulator.
    Chain i's key is ``fold_in(PRNGKey(seed), i)`` (``core.prng``), so its
    stream, and with it its accepted-move sequence, is the same at R = 16
    and at R = 256.

Menus: ``naive_sa`` samples uniformly over the valid rows; ``telemetry``
weights rows by the bottleneck seconds of the move's focus slot; ``farsi``
also multiplies in the Algorithm-1 move-kind precedence (join > migrate ≈
attach > fork > swap).

The draws are the JAX package's threefry draws and the accept test its f32
arithmetic, so a block follows the reference's chains move for move. The
tensors' device picks where the block runs: on a CUDA card every iteration
launches the phase-sim kernel, on the CPU its plain PyTorch version prices.
:meth:`DeviceChainRunner.run_chains_host` drives the same step one iteration
per call, with the carry back on the host in between — the parity oracle of
the fused block.
"""
from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import dataclasses
import functools
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import prng
from .blocks import FREQ_LADDER_MHZ
from .backend import resolve_device
from .budgets import Budget
from .database import HardwareDatabase
from .design import Design
from .moves import MoveDelta, apply_mapping, mapping_delta
from .phase_sim_torch import (
    BIG,
    EncodedDesign,
    EncodedWorkload,
    alloc_rows,
    fill_budget,
    fill_row,
)
from .policy import copy_carry
from .tdg import TaskGraph

__all__ = [
    "MENUS",
    "MoveTable",
    "ChainCarry",
    "ChainRequest",
    "ChainBlockResult",
    "DeviceChainRunner",
    "copy_carry",
    "reconcile_mapping",
    "reconcile_alloc",
]

MENUS = ("naive_sa", "telemetry", "farsi")

# packed move-kind codes (MoveTable.kind). Even codes act on the PE class,
# odd on the MEM class; ``arg`` is a task index for migrate/fork and a slot
# index for join/swap/attach; ``dest`` is a slot index (migrate/fork), a
# ladder direction 0/1 (swap), or a NoC chain index (attach).
MV_MIG_PE, MV_MIG_MEM = 0, 1
MV_FORK_PE, MV_FORK_MEM = 2, 3
MV_JOIN_PE, MV_JOIN_MEM = 4, 5
MV_SWAP_PE, MV_SWAP_MEM = 6, 7
MV_ATT_PE, MV_ATT_MEM = 8, 9

# Algorithm-1 move precedence (moves.MOVE_PRECEDENCE), indexed by kind code:
# join 5 > migrate/attach 4 > fork 3 > swap 2 — the ``farsi`` menu folds
# log(precedence) into the sampling logits
_KIND_PRECEDENCE = np.asarray(
    [4.0, 4.0, 3.0, 3.0, 5.0, 5.0, 2.0, 2.0, 4.0, 4.0], np.float32
)

# frequency-rung ratio tables for the device swap move: stepping slot s from
# rung i to i±1 multiplies its closed-form coefficient columns in place —
# peak ops, mem bandwidth and leakage all scale linearly with f
# (db.pe_peak_ops / Block.peak_bandwidth / db.leakage_w), PE area scales
# with the timing-closure factor 0.6 + 0.4·f/800 (db.block_area_mm2); MEM
# area terms are frequency-independent in the encoding (DRAM PHY is fixed,
# SRAM per-MB carries no f-scale) and are left untouched.
_F = np.asarray(FREQ_LADDER_MHZ, np.float64)
_AREA_FS = 0.6 + 0.4 * (_F / 800.0)


def _ratio_table(vals: np.ndarray) -> np.ndarray:
    """(8, 2) f32: [i, 0] = vals[i-1]/vals[i] (step down), [i, 1] =
    vals[i+1]/vals[i] (step up); ladder ends hold 1.0 (masked invalid)."""
    r = np.ones((len(vals), 2), np.float32)
    r[1:, 0] = (vals[:-1] / vals[1:]).astype(np.float32)
    r[:-1, 1] = (vals[1:] / vals[:-1]).astype(np.float32)
    return r


_RATIO_F = _ratio_table(_F)
_RATIO_AREA = _ratio_table(_AREA_FS)
_N_RUNG = len(FREQ_LADDER_MHZ)


def _rung_of(freq_mhz: int) -> int:
    return int(np.argmin(np.abs(_F - float(freq_mhz))))


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_F32_TINY = np.finfo(np.float32).tiny


@functools.lru_cache(maxsize=None)
def _powf():
    """The C library's ``powf`` (loaded at first use, not at import)."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype = ctypes.c_float
    fn.argtypes = (ctypes.c_float, ctypes.c_float)
    return fn


def _ftz(x: np.float32) -> np.float32:
    return np.float32(0.0) if abs(x) < _F32_TINY else x


def temperatures(t0: float, decay: float, it0: int, k: int) -> np.ndarray:
    """The SA temperatures ``t0 · decay^it`` of iterations it0 .. it0+k-1, in
    f32 as the reference computes them: C ``powf`` of the f32 operands,
    products rounded to f32, results below the least normal f32 flushed to
    zero (its compiled CPU code runs with denormals flushed)."""
    t0f, df, powf = np.float32(t0), float(np.float32(decay)), _powf()
    return np.asarray(
        [_ftz(t0f * _ftz(np.float32(powf(df, float(np.float32(i))))))
         for i in range(it0, it0 + k)],
        np.float32,
    )


class ChainCarry(NamedTuple):
    """The full per-chain state of an (R, K) block. The first seven leaves
    are the mapping-only carry (order kept — checkpoints and parity tests
    iterate leaves positionally); the rest is the allocation state:
    active-slot masks over the capacity-padded slot inventories, the
    per-slot coefficient columns allocation moves mutate (fork copies, swap
    scales, join strands), frequency rungs, fork provenance (the
    *base-encoding* slot each slot was transitively cloned from — what
    :func:`reconcile_alloc` replays on the host design), and the per-chain
    (T, cap_pe) acceleration table. Host carries hold numpy arrays in the
    reference's dtypes (``key`` uint32); inside a block the leaves are
    tensors on the block's device (``key`` int64)."""

    task_pe: np.ndarray  # (R, T) i32
    task_mem: np.ndarray  # (R, T) i32
    fitness: np.ndarray  # (R,) f32
    key: np.ndarray  # (R, 2) u32 per-chain threefry key
    taboo: np.ndarray  # (R, M) i32 per-move taboo TTL
    pe_bneck: np.ndarray  # (R, cap_pe) f32 incumbent telemetry
    mem_bneck: np.ndarray  # (R, cap_mem) f32
    pe_active: np.ndarray  # (R, cap_pe) f32 active-slot mask
    mem_active: np.ndarray  # (R, cap_mem) f32
    pe_peak: np.ndarray  # (R, cap_pe) f32 coefficient columns …
    pe_pj: np.ndarray
    pe_leak: np.ndarray
    pe_area: np.ndarray
    pe_noc: np.ndarray  # (R, cap_pe) i32 NoC chain attachment
    pe_rung: np.ndarray  # (R, cap_pe) i32 frequency-ladder rung
    pe_src: np.ndarray  # (R, cap_pe) i32 fork provenance (base slot)
    mem_bw: np.ndarray  # (R, cap_mem) f32 …
    mem_pj: np.ndarray
    mem_leak: np.ndarray
    mem_area_fixed: np.ndarray
    mem_area_per_mb: np.ndarray
    mem_noc: np.ndarray  # (R, cap_mem) i32
    mem_rung: np.ndarray  # (R, cap_mem) i32
    mem_src: np.ndarray  # (R, cap_mem) i32
    accel: np.ndarray  # (R, T, cap_pe) f32 per-slot task acceleration


def reconcile_mapping(
    design: Design,
    res: "ChainBlockResult",
    g: TaskGraph,
    db: HardwareDatabase,
    enc: EncodedWorkload,
    ed: Optional[EncodedDesign] = None,
    delta: Optional[MoveDelta] = None,
) -> Dict[str, Dict[str, str]]:
    """Apply the winning chain's final mapping onto ``design`` in place
    (slot indices → block names via the encoding's slot dicts). Returns the
    changed assignments — empty dicts mean the block improved nothing over
    the incumbent mapping. Mapping-only: allocation state in the carry (if
    any) is ignored; mixed blocks reconcile via :func:`reconcile_alloc`."""
    if ed is None:
        ed = EncodedDesign.of(design, g, db, enc)
    inv_pe = {s: n for n, s in ed.pe_slot.items()}
    inv_mem = {s: n for n, s in ed.mem_slot.items()}
    w = res.winner
    ch_pe: Dict[str, str] = {}
    ch_mem: Dict[str, str] = {}
    for i, name in enumerate(enc.names):
        s = int(res.task_pe[w, i])
        if s != int(ed.task_pe[i]):
            ch_pe[name] = inv_pe[s]
        s = int(res.task_mem[w, i])
        if s != int(ed.task_mem[i]):
            ch_mem[name] = inv_mem[s]
    if ch_pe or ch_mem:
        apply_mapping(design, ch_pe, ch_mem, delta)
    return {"task_pe": ch_pe, "task_mem": ch_mem}


def _reconcile_class(
    design: Design,
    inv: Dict[int, str],
    active: np.ndarray,
    src: np.ndarray,
    rung: np.ndarray,
    noc: np.ndarray,
    base_noc: np.ndarray,
    out: Dict[str, object],
) -> Dict[int, str]:
    """One slot class (PE or MEM) of :func:`reconcile_alloc`: returns the
    carry-slot → block-name map after creating clones for forked slots and
    retuning/re-homing preserved originals. Removals are deferred to the
    caller (tasks must be re-mapped off doomed originals first)."""
    from .moves import attach_block, fork_block, retune_block

    s_base = len(inv)
    slot_name: Dict[int, str] = {}
    for j in range(active.shape[0]):
        if active[j] <= 0.5:
            continue
        f = int(FREQ_LADDER_MHZ[int(rung[j])])
        noc_name = design.noc_chain[int(noc[j])]
        if j < s_base and int(src[j]) == j:
            name = inv[j]
            slot_name[j] = name
            if design.blocks[name].freq_mhz != f:
                retune_block(design, name, f)
                out["retuned"][name] = f
            if j < len(base_noc) and int(noc[j]) != int(base_noc[j]):
                attach_block(design, name, noc_name)
                out["attached"][name] = noc_name
        else:
            origin = inv[int(src[j])]
            name = fork_block(design, origin, freq_mhz=f, noc=noc_name)
            slot_name[j] = name
            out["forked"].append(name)
    return slot_name


def reconcile_alloc(
    design: Design,
    res: "ChainBlockResult",
    g: TaskGraph,
    db: HardwareDatabase,
    enc: EncodedWorkload,
    ed: Optional[EncodedDesign] = None,
) -> Dict[str, object]:
    """Replay the winning chain's *platform* onto ``design`` in place: the
    mixed-move inverse of :func:`reconcile_mapping`. Uses the carry's fork
    provenance (``pe_src``/``mem_src`` point at the base-encoding slot each
    active slot was transitively cloned from) to rebuild the winner through
    ``moves.py``'s allocation bridge — clones for forked slots
    (:func:`~repro_torch.core.moves.fork_block`), frequency retunes for
    stepped rungs, NoC re-homes for attaches, then the task mapping, then
    removal of originals the winner joined away. ``design`` must be the
    same design that seeded the block's fresh carry (provenance indexes its
    encoding)."""
    if ed is None:
        ed = EncodedDesign.of(design, g, db, enc)
    from .moves import join_block

    cc = ChainCarry(*res.carry)
    w = res.winner
    out: Dict[str, object] = {
        "task_pe": {}, "task_mem": {}, "forked": [], "removed": [],
        "retuned": {}, "attached": {},
    }
    inv_pe = {s: n for n, s in ed.pe_slot.items()}
    inv_mem = {s: n for n, s in ed.mem_slot.items()}
    pe_names = _reconcile_class(
        design, inv_pe, np.asarray(cc.pe_active[w]), np.asarray(cc.pe_src[w]),
        np.asarray(cc.pe_rung[w]), np.asarray(cc.pe_noc[w]), ed.pe_noc, out,
    )
    mem_names = _reconcile_class(
        design, inv_mem, np.asarray(cc.mem_active[w]),
        np.asarray(cc.mem_src[w]), np.asarray(cc.mem_rung[w]),
        np.asarray(cc.mem_noc[w]), ed.mem_noc, out,
    )
    # task re-mapping (after clones exist, before doomed originals go)
    for i, name in enumerate(enc.names):
        p = pe_names[int(res.task_pe[w, i])]
        if design.task_pe[name] != p:
            design.task_pe[name] = p
            out["task_pe"][name] = p
        m = mem_names[int(res.task_mem[w, i])]
        if design.task_mem[name] != m:
            design.task_mem[name] = m
            out["task_mem"][name] = m
    # originals the winner joined away (or re-populated with a clone)
    for inv, act, src in (
        (inv_pe, np.asarray(cc.pe_active[w]), np.asarray(cc.pe_src[w])),
        (inv_mem, np.asarray(cc.mem_active[w]), np.asarray(cc.mem_src[w])),
    ):
        for j, name in inv.items():
            if act[j] <= 0.5 or int(src[j]) != j:
                join_block(design, name)
                out["removed"].append(name)
    return out


@dataclasses.dataclass(frozen=True)
class MoveTable:
    """``propose_moves`` as packed arrays: row m is one candidate move
    (``kind[m]`` ∈ the ``MV_*`` codes) with operand columns ``arg`` (task
    index for migrate/fork, slot index for join/swap/attach) and ``dest``
    (destination slot / ladder direction / NoC chain index). Every row is
    shape-preserving over the capacity-padded inventories, so the whole
    table is samplable inside the device loop; validity (no-op
    destinations, inactive slots, full capacity, ladder ends, taboo) is
    masked per chain from the carry."""

    kind: np.ndarray  # (M,) int32 MV_* code
    task: np.ndarray  # (M,) int32 operand (task or slot index — see class)
    dest: np.ndarray  # (M,) int32 destination operand

    @property
    def n_moves(self) -> int:
        return int(self.kind.shape[0])

    @staticmethod
    def of(
        ed: EncodedDesign,
        enc: EncodedWorkload,
        *,
        alloc: bool = False,
        cap_pe: Optional[int] = None,
        cap_mem: Optional[int] = None,
    ) -> "MoveTable":
        """Enumerate the move rows of ``ed``. Mapping-only (default): all
        T·(S_pe + S_mem) single-task migrates. ``alloc=True`` additionally
        enumerates fork/join/swap/NoC-attach rows over ``cap_pe``/``cap_mem``
        padded slot inventories (default: pow2 ≥ real + 1, so at least one
        fork slot is free)."""
        t = len(enc.names)
        s_pe = int(ed.pe_peak.shape[0])
        s_mem = int(ed.mem_bw.shape[0])
        n_noc = int(ed.noc_bw.shape[0])
        if not alloc:
            cap_pe, cap_mem = s_pe, s_mem
        else:
            cap_pe = cap_pe or _pow2_at_least(s_pe + 1)
            cap_mem = cap_mem or _pow2_at_least(s_mem + 1)
        kinds: List[np.ndarray] = []
        args: List[np.ndarray] = []
        dests: List[np.ndarray] = []
        ti = np.arange(t, dtype=np.int32)

        def rows(kind: int, arg: np.ndarray, dest: np.ndarray) -> None:
            kinds.append(np.full(arg.shape[0], kind, np.int32))
            args.append(arg.astype(np.int32))
            dests.append(dest.astype(np.int32))

        def cross(kind: int, a: np.ndarray, d: np.ndarray) -> None:
            rows(kind, np.repeat(a, d.shape[0]), np.tile(d, a.shape[0]))

        cross(MV_MIG_PE, ti, np.arange(cap_pe))
        cross(MV_MIG_MEM, ti, np.arange(cap_mem))
        if alloc:
            si_pe = np.arange(cap_pe, dtype=np.int32)
            si_mem = np.arange(cap_mem, dtype=np.int32)
            updn = np.arange(2, dtype=np.int32)
            cross(MV_FORK_PE, ti, si_pe)
            cross(MV_FORK_MEM, ti, si_mem)
            rows(MV_JOIN_PE, si_pe, np.zeros(cap_pe))
            rows(MV_JOIN_MEM, si_mem, np.zeros(cap_mem))
            cross(MV_SWAP_PE, si_pe, updn)
            cross(MV_SWAP_MEM, si_mem, updn)
            if n_noc > 1:
                cross(MV_ATT_PE, si_pe, np.arange(n_noc))
                cross(MV_ATT_MEM, si_mem, np.arange(n_noc))
        return MoveTable(
            kind=np.concatenate(kinds),
            task=np.concatenate(args),
            dest=np.concatenate(dests),
        )

    def delta_of(
        self, m: int, enc: EncodedWorkload, ed: EncodedDesign
    ) -> MoveDelta:
        """Unpack a *migrate* row ``m`` into an ordinary :class:`MoveDelta`
        (absolute task→block-name mapping) — the bridge back to the host
        move system. Allocation rows have no single-delta form; whole
        blocks reconcile through :func:`reconcile_alloc` instead."""
        k = int(self.kind[m])
        if k not in (MV_MIG_PE, MV_MIG_MEM):
            raise ValueError(f"row {m} (kind {k}) is not a migrate move")
        tname = enc.names[int(self.task[m])]
        d = int(self.dest[m])
        if k == MV_MIG_PE:
            inv = {s: n for n, s in ed.pe_slot.items()}
            return mapping_delta({tname: inv[d]}, {})
        inv = {s: n for n, s in ed.mem_slot.items()}
        return mapping_delta({}, {tname: inv[d]})


@dataclasses.dataclass
class ChainRequest:
    """One (R, K) exploration block the explorer asks its backend to price.

    Yielded by ``Explorer.run_chain_steps`` in place of a candidate list and
    answered with the :class:`ChainBlockResult` of ``backend.run_chains``.
    ``carry`` resumes the chain population from a previous block (or a
    ``device_sa`` policy checkpoint); ``it0`` keeps the SA temperature
    schedule global across blocks. ``alloc`` widens the move table to the
    mixed mapping+allocation menu over ``cap_pe``/``cap_mem`` padded slot
    inventories (pinned by the first block of a run so resumed carries stay
    shape-compatible; None derives pow2 capacities from the design)."""

    design: Design
    budget: Budget
    r: int
    k: int
    seed: int = 0
    it0: int = 0
    menu: str = "naive_sa"
    alpha: float = 0.05
    temperature0: float = 0.05
    temp_decay: float = 0.997
    taboo_ttl: int = 5
    carry: Optional[tuple] = None
    alloc: bool = False
    cap_pe: Optional[int] = None
    cap_mem: Optional[int] = None


@dataclasses.dataclass
class ChainBlockResult:
    """Host-side view of one priced (R, K) block. ``carry`` is the full
    chain state pulled back as numpy (the checkpointable object); the
    per-step traces cover every chain so parity and trajectory tests can
    replay any of them."""

    task_pe: np.ndarray  # (R, T) final task→PE-slot map per chain
    task_mem: np.ndarray  # (R, T) final task→MEM-slot map per chain
    fitness: np.ndarray  # (R,) final Eq.-7 fitness per chain
    move_idx: np.ndarray  # (R, K) sampled MoveTable row per step
    accepted: np.ndarray  # (R, K) bool accept/reject per step
    fit_trace: np.ndarray  # (R, K) incumbent fitness after each step
    carry: tuple  # numpy ChainCarry (resume / checkpoint)
    winner: int  # argmin-fitness chain index
    wall_s: float  # block wall-clock (including device sync)
    n_moves: int  # MoveTable rows (M)

    def seq(self, chain: int = 0) -> List[Tuple[int, int]]:
        """(move_idx, accepted) sequence of one chain — the parity object."""
        return [
            (int(m), int(a))
            for m, a in zip(self.move_idx[chain], self.accepted[chain])
        ]


# carry leaves the accept step swaps wholesale on accept/reject (everything
# mutable except fitness/key/taboo/telemetry)
_STATE = (
    "task_pe", "task_mem", "pe_active", "mem_active",
    "pe_peak", "pe_pj", "pe_leak", "pe_area", "pe_noc", "pe_rung", "pe_src",
    "mem_bw", "mem_pj", "mem_leak", "mem_area_fixed", "mem_area_per_mb",
    "mem_noc", "mem_rung", "mem_src", "accel",
)
# the platform columns a re-pricing reads from the carry
_PRICED = (
    "pe_peak", "pe_pj", "pe_leak", "pe_area", "pe_noc", "pe_active",
    "mem_bw", "mem_pj", "mem_leak", "mem_area_fixed", "mem_area_per_mb",
    "mem_noc", "mem_active",
)
# the rows every chain shares for a whole block: the NoC chain and budgets
_STATIC_ROWS = ("wl_budget", "power_budget", "area_budget", "alpha")


def carry_to(carry: ChainCarry, device) -> ChainCarry:
    """A host carry as tensors on ``device`` (``key`` as int64 words)."""
    leaves = []
    for name, x in zip(ChainCarry._fields, carry):
        x = np.array(x, dtype=np.int64 if name == "key" else None)  # a writable copy
        leaves.append(torch.from_numpy(x).to(device))
    return ChainCarry(*leaves)


def carry_to_host(carry: ChainCarry) -> ChainCarry:
    """A device carry as numpy in the reference's dtypes (``key`` uint32)."""
    leaves = []
    for name, x in zip(ChainCarry._fields, carry):
        a = x.cpu().numpy()
        leaves.append(a.astype(np.uint32) if name == "key" else a)
    return ChainCarry(*leaves)


def block_draws(key: torch.Tensor, k: int, n_moves: int):
    """The random draws of K iterations from the (R, 2) chain keys: each
    iteration splits its key three ways (the next key, the move's, the
    accept's), as the reference's step does. The draws depend on the key
    sequence alone, never on the carry, so only the split runs iteration by
    iteration; the Gumbel noise of the K categorical draws and the K accept
    uniforms are one batched call each, from the same random bits as draws
    made iteration by iteration.
    Returns the key after K splits, the (K, R, M) noise and the (K, R)
    uniforms."""
    k_move, k_acc = [], []
    for _ in range(k):
        keys = prng.split(key, 3)
        key = keys[:, 0]
        k_move.append(keys[:, 1])
        k_acc.append(keys[:, 2])
    return key, prng.gumbel(torch.stack(k_move), (n_moves,)), prng.uniform(torch.stack(k_acc))


class _ChainBlock:
    """One (R, K) block shape: K iterations of sample → apply → re-price →
    accept over R chains, on the device of the carry it is given. Built once
    per shape key and reused by every block of that shape."""

    def __init__(self, enc: EncodedWorkload, r: int, k: int, menu: str,
                 t0: float, decay: float, ttl: int, cap_pe: int, cap_mem: int,
                 device: torch.device):
        # deferred: core must stay importable before kernels.phase_sim
        # finishes initializing (the kernels package imports core)
        from ..kernels.phase_sim.chain import resimulate_chains

        self.resimulate = resimulate_chains
        self.enc = enc
        self.r, self.k, self.menu = r, k, menu
        self.t0, self.decay, self.ttl = t0, decay, ttl
        self.cap = {"pe": cap_pe, "mem": cap_mem}
        self.device = device
        self.t = len(enc.names)
        dev = device
        self.prec_log = torch.log(torch.from_numpy(_KIND_PRECEDENCE)).to(dev)
        self.ratio_f = torch.from_numpy(_RATIO_F).to(dev)
        self.ratio_a = torch.from_numpy(_RATIO_AREA).to(dev)
        self.slots = {c: torch.arange(n, device=dev) for c, n in self.cap.items()}
        self.tidx = torch.arange(self.t, device=dev)
        enc.on(dev)  # the workload's tensors exist before the loop starts

    # -- masked writes: a row whose index is the class capacity (or T) is a
    # write to the padding column past the end, i.e. no write at all --------
    @staticmethod
    def _hit(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return cols[None, :] == idx[:, None]

    def _set(self, x, cols, idx, val):
        return torch.where(self._hit(cols, idx), val[:, None].to(x.dtype), x)

    def _apply_move(self, c: ChainCarry, kd, a, d) -> ChainCarry:
        """Apply each chain's sampled row (kind ``kd``, operands ``a``,
        ``d``; all (R,)) to its platform state. Every move class writes
        through a masked write whose index is out of range for rows of
        another class, so the write vanishes — one graph, no per-kind
        branches. Order per class: mapping, fork clone (gathered through
        the old map), join, swap (rung read before the fork's write),
        attach; the PE class, then the MEM class."""
        s = {f: getattr(c, f) for f in _STATE}
        t = self.t
        a_task = a.clamp(0, t - 1)
        dsw = d.clamp(0, 1)  # swap rows: dest is the direction bit
        step = 2 * dsw - 1
        for cls, mig, frk, jn, sw, att in (
            ("pe", MV_MIG_PE, MV_FORK_PE, MV_JOIN_PE, MV_SWAP_PE, MV_ATT_PE),
            ("mem", MV_MIG_MEM, MV_FORK_MEM, MV_JOIN_MEM, MV_SWAP_MEM, MV_ATT_MEM),
        ):
            cap, cols = self.cap[cls], self.slots[cls]
            tmap = f"task_{cls}"
            rung = s[f"{cls}_rung"]
            cols_f = (
                ("pe_peak", "pe_pj", "pe_leak", "pe_area")
                if cls == "pe"
                else ("mem_bw", "mem_pj", "mem_leak", "mem_area_fixed",
                      "mem_area_per_mb")
            )
            # rung-ratio columns: rates/leak scale with f, PE area with the
            # timing-closure factor; MEM area is f-independent
            sw_cols = (
                (("pe_peak", self.ratio_f), ("pe_leak", self.ratio_f),
                 ("pe_area", self.ratio_a))
                if cls == "pe"
                else (("mem_bw", self.ratio_f), ("mem_leak", self.ratio_f))
            )
            misc = (f"{cls}_noc", f"{cls}_rung", f"{cls}_src")
            # mapping write (migrate/fork re-home task ``a`` to ``d``)
            ti = torch.where((kd == mig) | (kd == frk), a, t)
            s[tmap] = self._set(s[tmap], self.tidx, ti, d)
            # fork: clone the forked task's pre-move slot into slot ``d``
            # (gathered through the OLD map — the mapping write above
            # already re-pointed the task at d)
            old_tm = getattr(c, tmap)
            src_slot = old_tm.gather(1, a_task[:, None]).long().clamp(0, cap - 1)
            fi = torch.where(kd == frk, d, cap)
            for f in cols_f + misc:
                s[f] = self._set(s[f], cols, fi, s[f].gather(1, src_slot)[:, 0])
            act = f"{cls}_active"
            s[act] = torch.where(self._hit(cols, fi), 1.0, s[act])
            if cls == "pe":
                acc = s["accel"]
                src_col = acc.gather(2, src_slot[:, :, None].expand(-1, t, 1))
                s["accel"] = torch.where(self._hit(cols, fi)[:, None, :], src_col, acc)
            # join: deactivate the (empty) slot ``a``
            ji = torch.where(kd == jn, a, cap)
            s[act] = torch.where(self._hit(cols, ji), 0.0, s[act])
            # swap: step slot ``a`` one frequency rung, scaling the
            # closed-form columns by the static ladder ratios
            si = torch.where(kd == sw, a, cap)
            hit = self._hit(cols, si)
            r_cur = rung.gather(1, a.clamp(0, cap - 1)[:, None])[:, 0].long()
            r_cur = r_cur.clamp(0, _N_RUNG - 1)
            for f, tab in sw_cols:
                s[f] = torch.where(hit, s[f] * tab[r_cur, dsw][:, None], s[f])
            rk = f"{cls}_rung"
            s[rk] = torch.where(hit, s[rk] + step[:, None].to(s[rk].dtype), s[rk])
            # attach: re-home slot ``a`` to NoC chain position ``d``
            ai = torch.where(kd == att, a, cap)
            nk = f"{cls}_noc"
            s[nk] = self._set(s[nk], cols, ai, d)
        return c._replace(**s)

    def _step(self, c: ChainCarry, tab: Dict[str, torch.Tensor],  # repro_torch: hot
              rows_static: Dict[str, torch.Tensor], temp_pos, temp_den,
              noise: torch.Tensor, u: torch.Tensor):
        """One iteration; ``noise`` (R, M) and ``u`` (R,) are its Gumbel
        noise and accept uniforms from :func:`block_draws`."""
        taboo = (c.taboo - 1).clamp(min=0)
        c = c._replace(taboo=taboo)
        # ---- validity over the packed table ------------------------------
        kind, arg, dest = tab["kind"], tab["arg"], tab["dest"]
        a_task, a_pe, a_mem = tab["a_task"], tab["a_pe"], tab["a_mem"]
        d_pe, d_mem = tab["d_pe"], tab["d_mem"]
        task_pe, task_mem = c.task_pe.long(), c.task_mem.long()
        cur_pe = task_pe[:, a_task]  # (R, M)
        cur_mem = task_mem[:, a_task]
        load_pe = (task_pe[:, :, None] == self.slots["pe"]).sum(1)  # (R, cap_pe)
        load_mem = (task_mem[:, :, None] == self.slots["mem"]).sum(1)
        act_pe_d = c.pe_active[:, d_pe] > 0
        act_mem_d = c.mem_active[:, d_mem] > 0
        act_pe_a = c.pe_active[:, a_pe] > 0
        act_mem_a = c.mem_active[:, a_mem] > 0
        rung_pe = c.pe_rung[:, a_pe] + tab["step_r"]
        rung_mem = c.mem_rung[:, a_mem] + tab["step_r"]
        in_lad = lambda x: (x >= 0) & (x < _N_RUNG)
        is_k = tab["is_kind"]
        dest_r = dest[None, :]
        valid = (
            (is_k[MV_MIG_PE] & (dest_r != cur_pe) & act_pe_d)
            | (is_k[MV_MIG_MEM] & (dest_r != cur_mem) & act_mem_d)
            | (is_k[MV_FORK_PE] & ~act_pe_d & (load_pe.gather(1, cur_pe) >= 2))
            | (is_k[MV_FORK_MEM] & ~act_mem_d & (load_mem.gather(1, cur_mem) >= 2))
            | (is_k[MV_JOIN_PE] & act_pe_a & (load_pe[:, a_pe] == 0))
            | (is_k[MV_JOIN_MEM] & act_mem_a & (load_mem[:, a_mem] == 0))
            | (is_k[MV_SWAP_PE] & act_pe_a & in_lad(rung_pe))
            | (is_k[MV_SWAP_MEM] & act_mem_a & in_lad(rung_mem))
            | (is_k[MV_ATT_PE] & act_pe_a & (dest_r != c.pe_noc[:, a_pe]))
            | (is_k[MV_ATT_MEM] & act_mem_a & (dest_r != c.mem_noc[:, a_mem]))
        ) & (taboo == 0)
        any_valid = valid.any(1)  # (R,)
        # ---- menu logits --------------------------------------------------
        if self.menu in ("telemetry", "farsi"):
            w_task = torch.where(
                tab["is_pe_cls"], c.pe_bneck.gather(1, cur_pe),
                c.mem_bneck.gather(1, cur_mem),
            )
            w_slot = torch.where(
                tab["is_pe_cls"], c.pe_bneck[:, a_pe], c.mem_bneck[:, a_mem]
            )
            logw = torch.log(torch.where(tab["is_task_arg"], w_task, w_slot) + 1e-6)
            if self.menu == "farsi":
                logw = logw + tab["prec_log"]
        else:
            logw = tab["zeros"]
        logits = torch.where(valid, logw, -1e30)
        m = torch.argmax(noise + logits, -1)  # prng.categorical, noise drawn ahead
        # ---- apply + price the candidate platforms ------------------------
        cand = self._apply_move(c, kind[m], arg[m], dest[m])
        rows = dict(rows_static)
        rows["task_pe"] = cand.task_pe
        rows["task_mem"] = cand.task_mem
        rows["pe_accel"] = cand.accel.gather(2, cand.task_pe.long()[:, :, None])[:, :, 0]
        for f in _PRICED:
            rows[f] = getattr(cand, f)
        res = self.resimulate(self.enc, rows)
        f_new = res["fitness"]
        # SA accept, the f32 mirror of PolicyBase.accept; chains whose whole
        # menu was masked (all-taboo / degenerate platform) force-reject and
        # leave every state leaf untouched
        ok = torch.isfinite(f_new) & (
            (f_new < c.fitness)
            | (temp_pos & (u < torch.exp(-(f_new - c.fitness) / temp_den)))
        )
        ok = ok & any_valid
        okc = ok[:, None]
        merged = {
            f: torch.where(okc if getattr(c, f).dim() == 2 else okc[:, :, None],
                           getattr(cand, f), getattr(c, f))
            for f in _STATE
        }
        fit = torch.where(ok, f_new, c.fitness)
        tab_wr = torch.where(tab["rows"] == m[:, None], self.ttl, taboo)
        taboo2 = torch.where((ok | ~any_valid)[:, None], taboo, tab_wr)
        pe_b = torch.where(okc, res["pe_bneck_s"], c.pe_bneck)
        mem_b = torch.where(okc, res["mem_bneck_s"], c.mem_bneck)
        c = c._replace(fitness=fit, taboo=taboo2, pe_bneck=pe_b, mem_bneck=mem_b, **merged)
        return c, m.to(torch.int32), ok, fit

    def __call__(self, carry: ChainCarry, it0: int, row0: Dict[str, np.ndarray],
                 table: MoveTable, loop_guard=contextlib.nullcontext):
        """Run the block's K iterations from ``carry`` (tensors on this
        block's device); returns the final carry and the (R, K) move,
        accept and fitness traces, all on the device, unsynchronised.
        ``loop_guard()`` is entered around the K iterations alone (the
        static inputs are made before it)."""
        dev, r, k = self.device, self.r, self.k
        cap_pe, cap_mem = self.cap["pe"], self.cap["mem"]
        # static per-block inputs, made before the loop: the table's columns
        # and the masks derived from them, the NoC chain + budget rows
        # (materialised per chain: the kernel reads contiguous rows), and
        # the K temperatures of this block
        kind = torch.from_numpy(table.kind).to(dev).long()
        arg = torch.from_numpy(table.task).to(dev).long()
        dest = torch.from_numpy(table.dest).to(dev).long()
        n_moves = table.n_moves
        tab = {
            "kind": kind, "arg": arg, "dest": dest,
            "a_task": arg.clamp(0, self.t - 1),
            "a_pe": arg.clamp(0, cap_pe - 1), "a_mem": arg.clamp(0, cap_mem - 1),
            "d_pe": dest.clamp(0, cap_pe - 1), "d_mem": dest.clamp(0, cap_mem - 1),
            "step_r": (2 * dest.clamp(0, 1) - 1)[None, :],
            "is_kind": [(kind == code)[None, :] for code in range(len(_KIND_PRECEDENCE))],
            "is_pe_cls": (kind % 2 == 0)[None, :],
            "is_task_arg": (kind <= MV_FORK_MEM)[None, :],
            "prec_log": self.prec_log[kind][None, :],
            "zeros": torch.zeros((r, n_moves), dtype=torch.float32, device=dev),
            "rows": torch.arange(n_moves, device=dev)[None, :],
        }
        rows_static = {
            n: torch.from_numpy(np.broadcast_to(v, (r,) + np.shape(v)).copy()).to(dev)
            for n, v in row0.items()
            if n.startswith("noc_") or n in _STATIC_ROWS
        }
        temps = temperatures(self.t0, self.decay, it0, k)
        temp = torch.from_numpy(temps).to(dev)
        temp_pos = temp > 0
        temp_den = torch.clamp(temp, min=float(np.float32(1e-9)))
        with loop_guard():
            return self._iterate(carry, tab, rows_static, temp_pos, temp_den, n_moves)

    def _iterate(self, carry: ChainCarry, tab: Dict[str, torch.Tensor],  # repro_torch: hot
                 rows_static: Dict[str, torch.Tensor], temp_pos, temp_den, n_moves: int):
        """The K iterations alone: the block's draws, then K steps. Returns
        the final carry and the (R, K) move, accept and fitness traces."""
        key, noise, u = block_draws(carry.key, self.k, n_moves)
        c = carry._replace(key=key)
        mv, acc, ft = [], [], []
        for s in range(self.k):
            c, m, ok, fit = self._step(c, tab, rows_static, temp_pos[s], temp_den[s],
                                       noise[s], u[s])
            mv.append(m)
            acc.append(ok)
            ft.append(fit)
        return c, torch.stack(mv, 1), torch.stack(acc, 1), torch.stack(ft, 1)


class DeviceChainRunner:
    """Owns the (R, K) chain blocks for one workload, on one device.

    Blocks are cached on everything that changes the step: (R, K, slot
    capacities, chain length, menu, alloc flag, SA constants).
    ``n_compiles`` counts the cache entries. There is no fallback path: a
    design the flat encoding cannot host (``UnsupportedDesignError``) fails
    loudly instead of silently degrading to a host loop, so ``n_fallback``
    is 0 by construction. ``device=None`` means the card, and raises where
    there is none; on the card every iteration prices through the phase-sim
    kernel, on the CPU through its plain version."""

    def __init__(
        self,
        g: TaskGraph,
        db: HardwareDatabase,
        enc: Optional[EncodedWorkload] = None,
        *,
        device=None,
    ):
        self.g = g
        self.db = db
        self.enc = enc if enc is not None else EncodedWorkload.of(g)
        self.device = resolve_device(device)
        self._blocks: Dict[tuple, _ChainBlock] = {}
        # entered around every block's K iterations (e.g. a context that
        # turns host synchronisation into an error)
        self.loop_guard = contextlib.nullcontext
        self.n_compiles = 0
        self.n_fallback = 0  # always 0: kept so the stats match the reference's
        self.n_dispatches = 0
        self.n_chain_steps = 0

    # -- host-side staging -------------------------------------------------
    def _row0(self, ed: EncodedDesign, budget: Budget, alpha: float):
        t = len(self.enc.names)
        rows = alloc_rows(
            1, t, int(ed.pe_peak.shape[0]), int(ed.mem_bw.shape[0]),
            len(self.enc.wl_names), int(ed.noc_bw.shape[0]),
        )
        fill_row(rows, 0, ed)
        fill_budget(
            rows, 0, self.enc,
            budget.latency_s, budget.power_w, budget.area_mm2, alpha,
        )
        return {k: v[0] for k, v in rows.items()}

    def _accel_table(
        self, design: Design, ed: EncodedDesign, cap_pe: Optional[int] = None
    ) -> np.ndarray:
        """(T, cap_pe) effective acceleration of task t if mapped to PE slot
        p — ``pe_accel`` is a per-task column, so a device migrate re-gathers
        it from this table instead of asking the hardware DB mid-loop.
        Padded slots accelerate nothing (1.0); a device fork copies its
        source slot's column, so clones inherit the hardened profile."""
        t = len(self.enc.names)
        cap = cap_pe or int(ed.pe_peak.shape[0])
        tab = np.ones((t, cap), np.float32)
        tasks = self.g.tasks
        for name, s in ed.pe_slot.items():
            b = design.blocks[name]
            if b.subtype == "acc" and b.hardened_for in self.enc.index:
                k = self.enc.index[b.hardened_for]
                tab[k, s] = self.db.a_peak(
                    b.hardened_for, tasks[b.hardened_for].llp, b.unroll
                )
        return tab

    @staticmethod
    def _pad_cols(col: np.ndarray, cap: int, pad: float, dtype) -> np.ndarray:
        out = np.full(cap, pad, dtype)
        out[: col.shape[0]] = col
        return out

    def fresh_carry(
        self,
        design: Design,
        ed: EncodedDesign,
        r: int,
        seed: int,
        *,
        cap_pe: Optional[int] = None,
        cap_mem: Optional[int] = None,
        alloc: Optional[bool] = None,
    ) -> ChainCarry:
        """Initial chain-population carry (numpy): every chain starts from
        the live design with fitness BIG (the first finite candidate is
        accepted, exactly like the host explorer pricing its seed), zero
        taboo, zero telemetry, all real slots active / padded slots
        inactive, rungs read off the blocks' frequency knobs, provenance =
        own slot, and key ``fold_in(PRNGKey(seed), chain_index)`` — the
        per-chain stream is a function of (seed, chain) only, never of R."""
        t = len(self.enc.names)
        s_pe = int(ed.pe_peak.shape[0])
        s_mem = int(ed.mem_bw.shape[0])
        cap_pe = cap_pe or s_pe
        cap_mem = cap_mem or s_mem
        if alloc is None:
            alloc = cap_pe > s_pe or cap_mem > s_mem
        m = MoveTable.of(
            ed, self.enc, alloc=alloc, cap_pe=cap_pe, cap_mem=cap_mem
        ).n_moves
        keys = prng.fold_in(prng.prng_key(seed), torch.arange(r)).numpy().astype(np.uint32)
        inv_pe = {s: n for n, s in ed.pe_slot.items()}
        inv_mem = {s: n for n, s in ed.mem_slot.items()}
        pe_rung = np.zeros(cap_pe, np.int32)
        for s in range(s_pe):
            pe_rung[s] = _rung_of(design.blocks[inv_pe[s]].freq_mhz)
        mem_rung = np.zeros(cap_mem, np.int32)
        for s in range(s_mem):
            mem_rung[s] = _rung_of(design.blocks[inv_mem[s]].freq_mhz)
        pad = self._pad_cols
        bc = lambda a: np.broadcast_to(a, (r,) + a.shape).copy()
        accel = np.ones((t, cap_pe), np.float32)
        accel[:, :s_pe] = self._accel_table(design, ed)[:, :s_pe]
        return ChainCarry(
            task_pe=np.broadcast_to(ed.task_pe, (r, t)).copy(),
            task_mem=np.broadcast_to(ed.task_mem, (r, t)).copy(),
            fitness=np.full((r,), BIG, np.float32),
            key=keys,
            taboo=np.zeros((r, m), np.int32),
            pe_bneck=np.zeros((r, cap_pe), np.float32),
            mem_bneck=np.zeros((r, cap_mem), np.float32),
            pe_active=bc(pad(ed.pe_active, cap_pe, 0.0, np.float32)),
            mem_active=bc(pad(ed.mem_active, cap_mem, 0.0, np.float32)),
            pe_peak=bc(pad(ed.pe_peak, cap_pe, 1.0, np.float32)),
            pe_pj=bc(pad(ed.pe_pj, cap_pe, 0.0, np.float32)),
            pe_leak=bc(pad(ed.pe_leak, cap_pe, 0.0, np.float32)),
            pe_area=bc(pad(ed.pe_area, cap_pe, 0.0, np.float32)),
            pe_noc=bc(pad(ed.pe_noc, cap_pe, 0, np.int32)),
            pe_rung=bc(pe_rung),
            pe_src=bc(np.arange(cap_pe, dtype=np.int32)),
            mem_bw=bc(pad(ed.mem_bw, cap_mem, 1.0, np.float32)),
            mem_pj=bc(pad(ed.mem_pj, cap_mem, 0.0, np.float32)),
            mem_leak=bc(pad(ed.mem_leak, cap_mem, 0.0, np.float32)),
            mem_area_fixed=bc(pad(ed.mem_area_fixed, cap_mem, 0.0, np.float32)),
            mem_area_per_mb=bc(pad(ed.mem_area_per_mb, cap_mem, 0.0, np.float32)),
            mem_noc=bc(pad(ed.mem_noc, cap_mem, 0, np.int32)),
            mem_rung=bc(mem_rung),
            mem_src=bc(np.arange(cap_mem, dtype=np.int32)),
            accel=bc(accel),
        )

    # -- the fused block ---------------------------------------------------
    def _block(
        self, r: int, k: int, ed: EncodedDesign, menu: str,
        t0: float, decay: float, ttl: int, alloc: bool,
        cap_pe: int, cap_mem: int,
    ) -> _ChainBlock:
        key = (
            r, k, cap_pe, cap_mem,
            int(ed.noc_bw.shape[0]), menu, float(t0), float(decay), int(ttl),
            alloc,
        )
        fn = self._blocks.get(key)
        if fn is None:
            fn = _ChainBlock(
                self.enc, r, k, menu, float(t0), float(decay), int(ttl),
                cap_pe, cap_mem, self.device,
            )
            self._blocks[key] = fn
            self.n_compiles += 1
        return fn

    def _capacities(
        self, ed: EncodedDesign, alloc: bool,
        cap_pe: Optional[int], cap_mem: Optional[int],
        carry: Optional[tuple],
    ) -> Tuple[int, int]:
        """Resolve the padded slot capacities of a block: an explicit
        override wins, then a resumed carry's shape (capacity is pinned for
        a whole exploration), then pow2 ≥ real+1 (alloc) / real (mapping)."""
        if carry is not None:
            cc = ChainCarry(*carry)
            return int(cc.pe_active.shape[1]), int(cc.mem_active.shape[1])
        s_pe = int(ed.pe_peak.shape[0])
        s_mem = int(ed.mem_bw.shape[0])
        if not alloc:
            return s_pe, s_mem
        return (
            cap_pe or _pow2_at_least(s_pe + 1),
            cap_mem or _pow2_at_least(s_mem + 1),
        )

    # -- entry points ------------------------------------------------------
    def run_chains(
        self,
        design: Design,
        budget: Budget,
        *,
        r: int,
        k: int,
        seed: int = 0,
        it0: int = 0,
        menu: str = "naive_sa",
        alpha: float = 0.05,
        temperature0: float = 0.05,
        temp_decay: float = 0.997,
        taboo_ttl: int = 5,
        carry: Optional[tuple] = None,
        alloc: bool = False,
        cap_pe: Optional[int] = None,
        cap_mem: Optional[int] = None,
    ) -> ChainBlockResult:
        """Price one fused (R, K) exploration block: one copy of the carry
        to the device, K iterations, one copy back. ``alloc=True`` samples
        the mixed mapping+allocation menu over capacity-padded slot
        inventories; the default is the mapping-only table."""
        if menu not in MENUS:
            raise ValueError(f"unknown device move menu: {menu!r}")
        ed = EncodedDesign.of(design, self.g, self.db, self.enc)
        cap_pe, cap_mem = self._capacities(ed, alloc, cap_pe, cap_mem, carry)
        s_pe = int(ed.pe_peak.shape[0])
        s_mem = int(ed.mem_bw.shape[0])
        alloc = alloc or cap_pe > s_pe or cap_mem > s_mem
        table = MoveTable.of(
            ed, self.enc, alloc=alloc, cap_pe=cap_pe, cap_mem=cap_mem
        )
        row0 = self._row0(ed, budget, alpha)
        fn = self._block(
            r, k, ed, menu, temperature0, temp_decay, taboo_ttl, alloc,
            cap_pe, cap_mem,
        )
        if carry is None:
            carry = self.fresh_carry(
                design, ed, r, seed, cap_pe=cap_pe, cap_mem=cap_mem,
                alloc=alloc,
            )
        elif not isinstance(carry, ChainCarry):
            carry = ChainCarry(*carry)
        t_start = time.perf_counter()
        out_carry, mv, acc, ft = fn(carry_to(carry, self.device), it0, row0, table,
                                    self.loop_guard)
        out_carry = carry_to_host(out_carry)
        mv, acc, ft = mv.cpu().numpy(), acc.cpu().numpy(), ft.cpu().numpy()
        wall = time.perf_counter() - t_start
        self.n_dispatches += 1
        self.n_chain_steps += r * k
        return ChainBlockResult(
            task_pe=out_carry.task_pe,
            task_mem=out_carry.task_mem,
            fitness=out_carry.fitness,
            move_idx=mv,
            accepted=acc,
            fit_trace=ft,
            carry=out_carry,
            winner=int(np.argmin(out_carry.fitness)),
            wall_s=wall,
            n_moves=table.n_moves,
        )

    def run_chains_host(
        self,
        design: Design,
        budget: Budget,
        *,
        r: int = 1,
        n_steps: int,
        seed: int = 0,
        it0: int = 0,
        menu: str = "naive_sa",
        alpha: float = 0.05,
        temperature0: float = 0.05,
        temp_decay: float = 0.997,
        taboo_ttl: int = 5,
        carry: Optional[tuple] = None,
        alloc: bool = False,
        cap_pe: Optional[int] = None,
        cap_mem: Optional[int] = None,
    ) -> ChainBlockResult:
        """The host-driven reference accept loop: the SAME step, run K=1 at
        a time with the carry pulled back to the host between iterations —
        one call and one round trip per SA step, the regime of the classic
        host explorer. Because it shares the block body (same threefry
        draws, same f32 accept math — for the mixed mapping+allocation menu
        too), a fused K-step block must replay it bit for bit; this is the
        parity oracle."""
        t_start = time.perf_counter()
        mvs, accs, fts = [], [], []
        res = None
        for i in range(n_steps):
            res = self.run_chains(
                design, budget, r=r, k=1, seed=seed, it0=it0 + i, menu=menu,
                alpha=alpha, temperature0=temperature0, temp_decay=temp_decay,
                taboo_ttl=taboo_ttl, carry=carry, alloc=alloc,
                cap_pe=cap_pe, cap_mem=cap_mem,
            )
            carry = res.carry  # numpy — the per-iteration host round trip
            mvs.append(res.move_idx)
            accs.append(res.accepted)
            fts.append(res.fit_trace)
        wall = time.perf_counter() - t_start
        return ChainBlockResult(
            task_pe=res.task_pe,
            task_mem=res.task_mem,
            fitness=res.fitness,
            move_idx=np.concatenate(mvs, axis=1),
            accepted=np.concatenate(accs, axis=1),
            fit_trace=np.concatenate(fts, axis=1),
            carry=res.carry,
            winner=res.winner,
            wall_s=wall,
            n_moves=res.n_moves,
        )

    def reconcile(
        self,
        design: Design,
        res: ChainBlockResult,
        ed: Optional[EncodedDesign] = None,
        delta: Optional[MoveDelta] = None,
    ) -> Dict[str, Dict[str, str]]:
        """:func:`reconcile_mapping` against this runner's workload."""
        return reconcile_mapping(
            design, res, self.g, self.db, self.enc, ed=ed, delta=delta
        )

    def reconcile_alloc(
        self,
        design: Design,
        res: ChainBlockResult,
        ed: Optional[EncodedDesign] = None,
    ) -> Dict[str, object]:
        """:func:`reconcile_alloc` against this runner's workload."""
        return reconcile_alloc(
            design, res, self.g, self.db, self.enc, ed=ed
        )
