"""Batched phase-driven simulator in PyTorch: price a *batch* of SA
neighbours in one call.

A design is a flat array encoding (task→PE map, task→MEM map, per-slot knobs
and PPA coefficients) and the TDG is dense matrices, so one call evaluates
every candidate neighbour of an explorer iteration — or a whole population.

The host side is numpy and unchanged from the reference encoding:

  * **Incremental encoding** — a move emits a
    :class:`~repro_torch.core.moves.MoveDelta`; :func:`apply_delta` turns
    the cached encoding of the current design into the neighbour's encoding
    (bit-identical to a from-scratch :meth:`EncodedDesign.of`) without
    cloning or re-walking the Python object graph.
  * **Rows** — :func:`alloc_rows` / :func:`fill_row` / :func:`fill_budget`
    write encodings and Eq.-7 budgets into padded per-design buffers.

Torch tensors appear only at the device boundary: :class:`EncodedWorkload`
keeps numpy arrays and hands out device copies once per device
(:meth:`EncodedWorkload.on`), and :func:`simulate_batch` is the B-batched
torch formulation of the phase loop plus the Eq.-7 scoring — the plain
version the CUDA kernel (``repro_torch.kernels.phase_sim``) is held against.

Scope: chain-topology designs with up to ``MAX_NOC`` NoCs. ``N`` pads to a
power-of-two bucket per dispatch; the single-NoC case (``N == 1``) takes the
historic single-NoC formulation. Designs the encoding cannot host (chains
beyond ``MAX_NOC``) raise :class:`UnsupportedDesignError`, which the backend
catches to route those candidates to the scalar fallback.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .blocks import Block, BlockKind
from .database import HardwareDatabase
from .design import Design
from .moves import MoveDelta
from .tdg import TaskGraph, workload_of

BIG = 1e30

# the widest NoC chain the flat encoding hosts: chain positions are int32
# slot indices and the kernel keeps per-NoC accumulators in fixed registers,
# so the cap is a footprint guard, not a numerics limit (the link ladder
# tops out at 8 channels; explorations never grow chains past a handful)
MAX_NOC = 8

# the retire test is ``c_t <= phi * (1 + 1e-9)`` evaluated in f32, where the
# factor rounds to exactly 1.0; named so no path promotes it to double
RETIRE_SLACK = float(np.float32(1 + 1e-9))


class UnsupportedDesignError(ValueError):
    """The design's shape falls outside what the flat encoding can host
    (today: NoC chains longer than ``MAX_NOC``). Typed — rather than a bare
    ``assert`` that vanishes under ``python -O`` — so the batched backend can
    catch it and route the candidate to the scalar Python fallback instead of
    silently mis-pricing it."""


@dataclasses.dataclass
class WorkloadTensors:
    """One device's copy of an :class:`EncodedWorkload`, optionally padded
    on the task axis (padded tasks: zero work and bytes, no parents, no
    workload)."""

    work_ops: torch.Tensor  # (T,) f32
    read_bytes: torch.Tensor  # (T,) f32
    write_bytes: torch.Tensor  # (T,) f32
    burst: torch.Tensor  # (T,) f32
    parent_mask: torch.Tensor  # (T, T) bool: [i, j] = j is a parent of i
    parent_u8: torch.Tensor  # (T, T) uint8: parent_mask as bytes
    parent_words: torch.Tensor  # (T, ceil(T/32)) int32 bits: the kernel's form of parent_mask
    wl_id: torch.Tensor  # (T,) int32, -1 on padded tasks
    wl_hot: torch.Tensor  # (T, NW) bool one-hot of wl_id


@dataclasses.dataclass
class EncodedWorkload:
    """Static per-workload arrays (shared across all candidate designs),
    held as numpy on the host; :meth:`on` gives the device copy."""

    work_ops: np.ndarray  # (T,) f32
    read_bytes: np.ndarray  # (T,) f32
    write_bytes: np.ndarray  # (T,) f32
    burst: np.ndarray  # (T,) f32
    llp: np.ndarray  # (T,) f32
    parent_mask: np.ndarray  # (T, T) bool: [i, j] = j is a parent of i
    wl_id: np.ndarray  # (T,) int32 workload index per task
    names: List[str]
    wl_names: List[str]  # index -> workload name (graph name if unnamespaced)
    index: Dict[str, int] = dataclasses.field(default_factory=dict)
    _dev: Dict[tuple, WorkloadTensors] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @staticmethod
    def of(g: TaskGraph) -> "EncodedWorkload":
        names = list(g.tasks)
        idx = {n: i for i, n in enumerate(names)}
        t = len(names)
        pm = np.zeros((t, t), bool)
        for n in names:
            for p in g.parents[n]:
                pm[idx[n], idx[p]] = True
        wl_names: List[str] = []
        wl_id = np.zeros(t, np.int32)
        for i, n in enumerate(names):
            w = workload_of(n) if "." in n else g.name
            if w not in wl_names:
                wl_names.append(w)
            wl_id[i] = wl_names.index(w)
        f = lambda attr: np.asarray([getattr(g.tasks[n], attr) for n in names], np.float32)
        return EncodedWorkload(
            work_ops=f("work_ops"),
            read_bytes=f("read_bytes"),
            write_bytes=f("write_bytes"),
            burst=f("burst_bytes"),
            llp=f("llp"),
            parent_mask=pm,
            wl_id=wl_id,
            names=names,
            wl_names=wl_names,
            index=idx,
        )

    def on(self, device, pad_to: int = 0) -> WorkloadTensors:
        """The workload's tensors on ``device``, task axis padded to
        ``pad_to`` (no padding when ``pad_to`` ≤ T). Built once per
        (device, width) and cached: the backend moves the workload to the
        card once, not per dispatch."""
        device = torch.device(device)
        t = len(self.names)
        tp = max(pad_to, t)
        key = (str(device), tp)
        w = self._dev.get(key)
        if w is None:
            def vec(a, fill=0):
                out = np.full(tp, fill, a.dtype)
                out[:t] = a
                return torch.from_numpy(out).to(device)

            pm = np.zeros((tp, tp), bool)
            pm[:t, :t] = self.parent_mask
            wl = np.full(tp, -1, np.int32)
            wl[:t] = self.wl_id
            hot = wl[:, None] == np.arange(len(self.wl_names))[None, :]
            w = self._dev[key] = WorkloadTensors(
                work_ops=vec(self.work_ops),
                read_bytes=vec(self.read_bytes),
                write_bytes=vec(self.write_bytes),
                burst=vec(self.burst),
                parent_mask=torch.from_numpy(pm).to(device),
                parent_u8=torch.from_numpy(pm.astype(np.uint8)).to(device),
                parent_words=torch.from_numpy(pack_parent_words(pm)).to(device),
                wl_id=torch.from_numpy(wl).to(device),
                wl_hot=torch.from_numpy(hot).to(device),
            )
        return w


def pack_parent_words(pm: np.ndarray) -> np.ndarray:
    """A (T, T) bool parent mask as (T, ceil(T/32)) words of 32 bits: bit
    ``j % 32`` of word ``j // 32`` in row ``i`` is ``pm[i, j]``. int32 holds
    the bits (the kernel reads them as uint32)."""
    t = pm.shape[0]
    nw = -(-t // 32)
    bits = np.zeros((t, 32 * nw), np.uint64)
    bits[:, :pm.shape[1]] = pm
    words = (bits.reshape(t, nw, 32) << np.arange(32, dtype=np.uint64)).sum(-1)
    return words.astype(np.uint32).view(np.int32)


_WORKLOAD_DTYPES = {
    "work_ops": np.float32, "read_bytes": np.float32,
    "write_bytes": np.float32, "burst": np.float32, "llp": np.float32,
    "parent_mask": np.bool_, "wl_id": np.int32,
}


# ---------------------------------------------------------------------------
# per-slot PPA coefficients (host-side closed forms the kernel sums on device)
# ---------------------------------------------------------------------------
def _pe_coeffs(b: Block, db: HardwareDatabase):
    """(peak ops/s, pJ/op, leak W, area mm²) of one PE block."""
    e = db.energy
    pj = e.acc_pj_per_op if b.subtype == "acc" else e.gpp_pj_per_op
    return db.pe_peak_ops(b), pj, db.leakage_w(b), db.block_area_mm2(b)


def _mem_coeffs(b: Block, db: HardwareDatabase):
    """(peak B/s, pJ/B, leak W, fixed area mm², area mm²/MB) of one MEM.

    SRAM area scales with resident capacity (CACTI-style), so it is split
    into a per-MB term the kernel multiplies by the segment-summed write
    bytes; DRAM is a fixed PHY block."""
    e = db.energy
    pj = e.sram_pj_per_byte if b.subtype == "sram" else e.dram_pj_per_byte
    if b.subtype == "sram":
        fixed, per_mb = 0.0, db.area.sram_mm2_per_mb
    else:
        fixed, per_mb = db.block_area_mm2(b), 0.0
    return b.peak_bandwidth(db), pj, db.leakage_w(b), fixed, per_mb


def _accel_of(b: Block, task_name: str, llp: float, db: HardwareDatabase) -> float:
    if b.hardened_for == task_name and b.subtype == "acc":
        return db.a_peak(task_name, llp, b.unroll)
    return 1.0


@dataclasses.dataclass
class EncodedDesign:
    """Flat design encoding: task maps, per-slot knobs *and* per-slot PPA
    coefficients, so pricing never revisits the Python object graph. Slot
    order is the design's block insertion order (PEs and MEMs separately),
    which is what makes :func:`apply_delta` reproducible bit-for-bit."""

    task_pe: np.ndarray  # (T,) int32 PE slot per task
    task_mem: np.ndarray  # (T,) int32 MEM slot per task
    pe_accel: np.ndarray  # (T,) effective acceleration of the task's PE for it
    pe_peak: np.ndarray  # (S_pe,) ops/s at a=1 (freq × ops/cycle)
    pe_pj: np.ndarray  # (S_pe,) dynamic pJ/op
    pe_leak: np.ndarray  # (S_pe,) leakage W
    pe_area: np.ndarray  # (S_pe,) mm²
    mem_bw: np.ndarray  # (S_mem,) bytes/s
    mem_pj: np.ndarray  # (S_mem,) dynamic pJ/byte
    mem_leak: np.ndarray  # (S_mem,) leakage W
    mem_area_fixed: np.ndarray  # (S_mem,) mm² (DRAM PHY; 0 for SRAM)
    mem_area_per_mb: np.ndarray  # (S_mem,) mm²/MB (SRAM; 0 for DRAM)
    # per-class active-slot masks (1.0 = slot exists in the design). Host
    # encodes are always all-ones — padding stays a *buffer* concept — but
    # the device-resident explorer prices allocation moves by toggling these
    # in place over capacity-padded inventories: an inactive slot keeps its
    # pad-neutral rates yet contributes nothing to the leak/area rollup.
    pe_active: np.ndarray  # (S_pe,) f32 mask
    mem_active: np.ndarray  # (S_mem,) f32 mask
    # per-NoC arrays in CHAIN order (index = chain position, so the hop
    # distance between two NoCs is |i − j| and a task's route is the index
    # interval between its PE's and its MEM's attachment)
    noc_bw: np.ndarray  # (N,) bytes/s per link
    noc_links: np.ndarray  # (N,) int32 channels
    noc_leak: np.ndarray  # (N,) leakage W
    noc_area: np.ndarray  # (N,) mm²
    noc_active: np.ndarray  # (N,) f32 mask (see pe_active)
    pe_noc: np.ndarray  # (S_pe,) int32 chain index each PE attaches to
    mem_noc: np.ndarray  # (S_mem,) int32 chain index each MEM attaches to
    noc_pj: np.float32  # dynamic pJ/byte·hop (db constant, rides the row so
    # the kernel never hardcodes an energy-model default)
    pe_slot: Dict[str, int]  # block name -> slot
    mem_slot: Dict[str, int]
    noc_slot: Dict[str, int]  # NoC name -> chain index

    @staticmethod
    def of(design: Design, g: TaskGraph, db: HardwareDatabase, enc: EncodedWorkload) -> "EncodedDesign":
        if not 1 <= len(design.noc_chain) <= MAX_NOC:
            raise UnsupportedDesignError(
                f"NoC chain of {len(design.noc_chain)} outside the encodable "
                f"range [1, {MAX_NOC}]"
            )
        noc_i = {n: i for i, n in enumerate(design.noc_chain)}
        # single pass over blocks: slot index maps + per-slot rates/coefficients
        pe_i: Dict[str, int] = {}
        mem_i: Dict[str, int] = {}
        pe_cols: List[tuple] = []
        mem_cols: List[tuple] = []
        pe_noc: List[int] = []
        mem_noc: List[int] = []
        for n, b in design.blocks.items():
            if b.kind == BlockKind.PE:
                pe_i[n] = len(pe_cols)
                pe_cols.append(_pe_coeffs(b, db))
                pe_noc.append(noc_i[design.attached_noc[n]])
            elif b.kind == BlockKind.MEM:
                mem_i[n] = len(mem_cols)
                mem_cols.append(_mem_coeffs(b, db))
                mem_noc.append(noc_i[design.attached_noc[n]])
        t = len(enc.names)
        d_pe, d_mem, blocks, tasks = design.task_pe, design.task_mem, design.blocks, g.tasks
        task_pe = np.fromiter((pe_i[d_pe[n]] for n in enc.names), np.int32, t)
        task_mem = np.fromiter((mem_i[d_mem[n]] for n in enc.names), np.int32, t)
        accel = np.ones(t, np.float32)
        for k, n in enumerate(enc.names):
            b = blocks[d_pe[n]]
            if b.hardened_for == n and b.subtype == "acc":
                accel[k] = db.a_peak(n, tasks[n].llp, b.unroll)
        nocs = [blocks[n] for n in design.noc_chain]
        f32col = lambda cols, j: np.asarray([c[j] for c in cols], np.float32)
        return EncodedDesign(
            task_pe=task_pe,
            task_mem=task_mem,
            pe_accel=accel,
            pe_peak=f32col(pe_cols, 0),
            pe_pj=f32col(pe_cols, 1),
            pe_leak=f32col(pe_cols, 2),
            pe_area=f32col(pe_cols, 3),
            mem_bw=f32col(mem_cols, 0),
            mem_pj=f32col(mem_cols, 1),
            mem_leak=f32col(mem_cols, 2),
            mem_area_fixed=f32col(mem_cols, 3),
            mem_area_per_mb=f32col(mem_cols, 4),
            pe_active=np.ones(len(pe_cols), np.float32),
            mem_active=np.ones(len(mem_cols), np.float32),
            noc_bw=np.asarray([b.peak_bandwidth(db) for b in nocs], np.float32),
            noc_links=np.asarray([b.n_links for b in nocs], np.int32),
            noc_leak=np.asarray([db.leakage_w(b) for b in nocs], np.float32),
            noc_area=np.asarray([db.block_area_mm2(b) for b in nocs], np.float32),
            noc_active=np.ones(len(nocs), np.float32),
            pe_noc=np.asarray(pe_noc, np.int32),
            mem_noc=np.asarray(mem_noc, np.int32),
            noc_pj=np.float32(db.energy.noc_pj_per_byte_hop),
            pe_slot=pe_i,
            mem_slot=mem_i,
            noc_slot=noc_i,
        )


def _append1(arr: np.ndarray, v) -> np.ndarray:
    """np.append without its ravel/concatenate overhead (hot path)."""
    out = np.empty(arr.shape[0] + 1, arr.dtype)
    out[:-1] = arr
    out[-1] = v
    return out


def _delete1(arr: np.ndarray, s: int) -> np.ndarray:
    """np.delete of one index without its mask machinery (hot path)."""
    out = np.empty(arr.shape[0] - 1, arr.dtype)
    out[:s] = arr[:s]
    out[s:] = arr[s + 1:]
    return out


def _insert1(arr: np.ndarray, s: int, v) -> np.ndarray:
    """np.insert of one value without its generic machinery (hot path)."""
    out = np.empty(arr.shape[0] + 1, arr.dtype)
    out[:s] = arr[:s]
    out[s] = v
    out[s + 1:] = arr[s:]
    return out


_NOC_ARRAY_FIELDS = ("noc_bw", "noc_links", "noc_leak", "noc_area", "noc_active")


def _noc_cols(b: Block, db: HardwareDatabase) -> tuple:
    return (
        np.float32(b.peak_bandwidth(db)), np.int32(b.n_links),
        np.float32(db.leakage_w(b)), np.float32(db.block_area_mm2(b)),
        np.float32(1.0),
    )


def apply_delta(
    base: "EncodedDesign",
    delta: MoveDelta,
    design: Design,
    g: TaskGraph,
    db: HardwareDatabase,
    enc: EncodedWorkload,
) -> "EncodedDesign":
    """Incremental re-encode: the neighbour's :class:`EncodedDesign` from the
    *current* design's cached encoding plus the move's recorded delta —
    bit-identical to ``EncodedDesign.of`` on the mutated design (asserted in
    tests/test_encoding_delta.py), at a handful of O(S)/O(T) numpy edits
    instead of a full Python-object walk.

    ``design`` is the *base* (pre-move) design: only blocks the delta did not
    touch are read from it, so it may be called before or after rollback.
    """
    if delta.topology:
        raise UnsupportedDesignError("delta flagged as unencodable (topology)")
    # copy-on-write: fields the delta does not touch stay *shared* with the
    # base encoding (`ed.f is base.f`), which both keeps a typical swap/
    # migrate delta at a couple of tiny array copies and lets the backend
    # detect exactly which buffer fields need rewriting per candidate
    ed = dataclasses.replace(base)

    def own(*fields: str) -> None:
        for f in fields:
            v = getattr(ed, f)
            if v is getattr(base, f):
                setattr(ed, f, v.copy() if isinstance(v, np.ndarray) else dict(v))

    touched_pe_slots: List[int] = []

    # 1) removals (join): compact slots exactly like a from-scratch encode.
    # A removed NoC compacts the chain; blocks it hosted carry explicit
    # re-attachment edits (delta.attached), applied in step 4b below.
    for name in delta.removed:
        if name in ed.pe_slot:
            s = ed.pe_slot[name]
            for f in ("pe_peak", "pe_pj", "pe_leak", "pe_area", "pe_active"):
                setattr(ed, f, _delete1(getattr(ed, f), s))
            ed.pe_slot = {n: i - (i > s) for n, i in ed.pe_slot.items() if n != name}
            ed.task_pe = ed.task_pe - (ed.task_pe > s)
            ed.pe_noc = _delete1(ed.pe_noc, s)
        elif name in ed.mem_slot:
            s = ed.mem_slot[name]
            for f in (
                "mem_bw", "mem_pj", "mem_leak", "mem_area_fixed",
                "mem_area_per_mb", "mem_active",
            ):
                setattr(ed, f, _delete1(getattr(ed, f), s))
            ed.mem_slot = {n: i - (i > s) for n, i in ed.mem_slot.items() if n != name}
            ed.task_mem = ed.task_mem - (ed.task_mem > s)
            ed.mem_noc = _delete1(ed.mem_noc, s)
        elif name in ed.noc_slot:
            s = ed.noc_slot[name]
            for f in _NOC_ARRAY_FIELDS:
                setattr(ed, f, _delete1(getattr(ed, f), s))
            ed.noc_slot = {n: i - (i > s) for n, i in ed.noc_slot.items() if n != name}
            ed.pe_noc = ed.pe_noc - (ed.pe_noc > s)
            ed.mem_noc = ed.mem_noc - (ed.mem_noc > s)

    # 2a) NoC additions (fork): INSERT at the recorded chain position — chain
    # order is the slot order, so every downstream chain index shifts by one
    for b in delta.added:
        if b.kind != BlockKind.NOC:
            continue
        p = ed.noc_slot[delta.noc_after] + 1 if delta.noc_after else ed.noc_bw.shape[0]
        ed.noc_slot = {n: i + (i >= p) for n, i in ed.noc_slot.items()}
        ed.noc_slot[b.name] = p
        for f, v in zip(_NOC_ARRAY_FIELDS, _noc_cols(b, db)):
            setattr(ed, f, _insert1(getattr(ed, f), p, v))
        ed.pe_noc = ed.pe_noc + (ed.pe_noc >= p)
        ed.mem_noc = ed.mem_noc + (ed.mem_noc >= p)

    # 2b) PE/MEM additions (fork): append at the end, matching dict insertion
    # order; the new slot's NoC attachment is the recorded one
    for b in delta.added:
        if b.kind == BlockKind.PE:
            own("pe_slot")
            ed.pe_slot[b.name] = ed.pe_peak.shape[0]
            cols = _pe_coeffs(b, db)
            for f, v in zip(("pe_peak", "pe_pj", "pe_leak", "pe_area"), cols):
                setattr(ed, f, _append1(getattr(ed, f), np.float32(v)))
            ed.pe_active = _append1(ed.pe_active, np.float32(1.0))
            ed.pe_noc = _append1(ed.pe_noc, ed.noc_slot[delta.attached[b.name]])
            touched_pe_slots.append(ed.pe_slot[b.name])
        elif b.kind == BlockKind.MEM:
            own("mem_slot")
            ed.mem_slot[b.name] = ed.mem_bw.shape[0]
            cols = _mem_coeffs(b, db)
            for f, v in zip(
                ("mem_bw", "mem_pj", "mem_leak", "mem_area_fixed", "mem_area_per_mb"), cols
            ):
                setattr(ed, f, _append1(getattr(ed, f), np.float32(v)))
            ed.mem_active = _append1(ed.mem_active, np.float32(1.0))
            ed.mem_noc = _append1(ed.mem_noc, ed.noc_slot[delta.attached[b.name]])

    # 3) knob edits (swap): refresh the touched slot's rate + coefficients
    for name, snap in delta.touched.items():
        if snap.kind == BlockKind.NOC:
            s = ed.noc_slot[name]
            own(*_NOC_ARRAY_FIELDS)
            for f, v in zip(_NOC_ARRAY_FIELDS, _noc_cols(snap, db)):
                getattr(ed, f)[s] = v
        elif name in ed.pe_slot:
            s = ed.pe_slot[name]
            own("pe_peak", "pe_pj", "pe_leak", "pe_area")
            for f, v in zip(("pe_peak", "pe_pj", "pe_leak", "pe_area"), _pe_coeffs(snap, db)):
                getattr(ed, f)[s] = np.float32(v)
            touched_pe_slots.append(s)
        elif name in ed.mem_slot:
            s = ed.mem_slot[name]
            own("mem_bw", "mem_pj", "mem_leak", "mem_area_fixed", "mem_area_per_mb")
            for f, v in zip(
                ("mem_bw", "mem_pj", "mem_leak", "mem_area_fixed", "mem_area_per_mb"),
                _mem_coeffs(snap, db),
            ):
                getattr(ed, f)[s] = np.float32(v)

    # 4) mapping edits (migrate / fork / join reassignments)
    moved: List[int] = []
    if delta.task_pe:
        own("task_pe")
        for t, pe in delta.task_pe.items():
            k = enc.index[t]
            ed.task_pe[k] = ed.pe_slot[pe]
            moved.append(k)
    if delta.task_mem:
        own("task_mem")
        for t, mem in delta.task_mem.items():
            ed.task_mem[enc.index[t]] = ed.mem_slot[mem]

    # 4b) NoC re-attachments (NoC fork/join re-home attached blocks; newly
    # added slots were already born attached — re-setting is idempotent)
    for bname, nocname in delta.attached.items():
        p = ed.noc_slot[nocname]
        if bname in ed.pe_slot:
            own("pe_noc")
            ed.pe_noc[ed.pe_slot[bname]] = p
        elif bname in ed.mem_slot:
            own("mem_noc")
            ed.mem_noc[ed.mem_slot[bname]] = p

    # 5) acceleration refresh for every task whose PE (or its knobs) changed
    if touched_pe_slots or moved:
        slot_name = {s: n for n, s in ed.pe_slot.items()}
        affected = set(moved)
        for s in set(touched_pe_slots):
            affected.update(np.nonzero(ed.task_pe == s)[0].tolist())
        block_of: Dict[str, Block] = {b.name: b for b in delta.added}
        block_of.update(delta.touched)
        own("pe_accel")
        for k in affected:
            name = slot_name[int(ed.task_pe[k])]
            b = block_of.get(name) or design.blocks[name]
            tname = enc.names[k]
            ed.pe_accel[k] = _accel_of(b, tname, g.tasks[tname].llp, db)
    return ed


# per-design row keys, in the order buffers are allocated/filled
ROW_KEYS = (
    "task_pe", "task_mem", "pe_accel",
    "pe_peak", "pe_pj", "pe_leak", "pe_area", "pe_noc", "pe_active",
    "mem_bw", "mem_pj", "mem_leak", "mem_area_fixed", "mem_area_per_mb",
    "mem_noc", "mem_active",
    "noc_bw", "noc_links", "noc_leak", "noc_area", "noc_active", "noc_pj",
    "wl_budget", "power_budget", "area_budget", "alpha",
)


def alloc_rows(
    b: int, t: int, n_pe: int, n_mem: int, n_wl: int, n_noc: int = 1
) -> Dict[str, np.ndarray]:
    """Preallocate one batch of padded per-design rows (host buffers the
    backend reuses across dispatches of the same shape bucket). Pad values:
    rates 1.0 (div-by-zero-free, never hosting tasks), coefficients 0.0
    (they are summed), budgets BIG / alpha 0 (neutral scoring). Padded NoC
    slots (chain indices ≥ the design's real chain length) carry no attached
    blocks, so no route ever crosses them."""
    rows = {
        "task_pe": np.zeros((b, t), np.int32),
        "task_mem": np.zeros((b, t), np.int32),
        "pe_accel": np.ones((b, t), np.float32),
        "pe_peak": np.ones((b, n_pe), np.float32),
        "pe_pj": np.zeros((b, n_pe), np.float32),
        "pe_leak": np.zeros((b, n_pe), np.float32),
        "pe_area": np.zeros((b, n_pe), np.float32),
        "pe_noc": np.zeros((b, n_pe), np.int32),
        "pe_active": np.zeros((b, n_pe), np.float32),
        "mem_bw": np.ones((b, n_mem), np.float32),
        "mem_pj": np.zeros((b, n_mem), np.float32),
        "mem_leak": np.zeros((b, n_mem), np.float32),
        "mem_area_fixed": np.zeros((b, n_mem), np.float32),
        "mem_area_per_mb": np.zeros((b, n_mem), np.float32),
        "mem_noc": np.zeros((b, n_mem), np.int32),
        "mem_active": np.zeros((b, n_mem), np.float32),
        "noc_bw": np.ones((b, n_noc), np.float32),
        "noc_links": np.ones((b, n_noc), np.int32),
        "noc_leak": np.zeros((b, n_noc), np.float32),
        "noc_area": np.zeros((b, n_noc), np.float32),
        "noc_active": np.zeros((b, n_noc), np.float32),
        "noc_pj": np.zeros((b,), np.float32),
        "wl_budget": np.full((b, n_wl), BIG, np.float32),
        "power_budget": np.full((b,), BIG, np.float32),
        "area_budget": np.full((b,), BIG, np.float32),
        "alpha": np.zeros((b,), np.float32),
    }
    return rows


_TASK_FIELDS = ("task_pe", "task_mem", "pe_accel")
_PE_FIELDS = ("pe_peak", "pe_pj", "pe_leak", "pe_area", "pe_noc", "pe_active")
_MEM_FIELDS = (
    "mem_bw", "mem_pj", "mem_leak", "mem_area_fixed", "mem_area_per_mb",
    "mem_noc", "mem_active",
)
ENCODED_FIELDS = _TASK_FIELDS + _PE_FIELDS + _MEM_FIELDS + _NOC_ARRAY_FIELDS


def fill_row_fields(
    rows: Dict[str, np.ndarray], j: int, ed: EncodedDesign, fields
) -> None:
    """Write a subset of one design's encoding into row ``j`` — the backend
    pairs this with the copy-on-write :func:`apply_delta` to rewrite only the
    buffer fields a candidate's move actually changed (``ed.f is not
    base.f``); everything else keeps the broadcast base-row content."""
    for f in fields:
        if f in _TASK_FIELDS:
            rows[f][j] = getattr(ed, f)
        elif f in _PE_FIELDS:
            s = ed.pe_peak.shape[0]
            rows[f][j, :s] = getattr(ed, f)
            rows[f][j, s:] = 1.0 if f == "pe_peak" else 0.0
        elif f in _MEM_FIELDS:
            m = ed.mem_bw.shape[0]
            rows[f][j, :m] = getattr(ed, f)
            rows[f][j, m:] = 1.0 if f == "mem_bw" else 0.0
        else:  # per-NoC chain arrays
            n = ed.noc_bw.shape[0]
            rows[f][j, :n] = getattr(ed, f)
            rows[f][j, n:] = 1.0 if f in ("noc_bw", "noc_links") else 0.0


def fill_row(rows: Dict[str, np.ndarray], j: int, ed: EncodedDesign) -> None:
    """Write one design's full encoding into row ``j`` of the padded buffers."""
    fill_row_fields(rows, j, ed, ENCODED_FIELDS)
    rows["noc_pj"][j] = ed.noc_pj


def fill_budget(
    rows: Dict[str, np.ndarray], j: int, enc: EncodedWorkload,
    latency_s: Dict[str, float], power_w: float, area_mm2: float, alpha: float,
) -> None:
    """Write one design's Eq.-7 budget row (device-side fitness inputs).
    Workloads the budget does not name score BIG (distance ≈ −1, never the
    binding term)."""
    rows["wl_budget"][j] = [latency_s.get(w, BIG) for w in enc.wl_names]
    rows["power_budget"][j] = power_w
    rows["area_budget"][j] = area_mm2
    rows["alpha"][j] = alpha


def rows_to(rows: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host rows dict (numpy, :func:`alloc_rows` layout) as tensors on
    ``device`` — zero-copy views on the CPU."""
    device = torch.device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in rows.items()}


def from_reference(
    workload: Dict[str, np.ndarray],
    names: Sequence[str],
    wl_names: Sequence[str],
    rows: Dict[str, np.ndarray],
    device,
) -> Tuple[EncodedWorkload, Dict[str, torch.Tensor]]:
    """Carry another implementation's encoded state across as numpy.

    ``workload`` holds the arrays of an encoded workload (``work_ops``,
    ``read_bytes``, ``write_bytes``, ``burst``, ``llp``, ``parent_mask``,
    ``wl_id``); ``rows`` is an :func:`encode_batch`/:func:`alloc_rows` rows
    dict. Keys and dtypes are checked against ``ROW_KEYS`` and the
    :func:`alloc_rows` layout. Returns this package's
    :class:`EncodedWorkload` and the row tensors on ``device``."""
    missing = set(_WORKLOAD_DTYPES) - set(workload)
    if missing:
        raise KeyError(f"workload arrays missing: {sorted(missing)}")
    arrs = {}
    for k, dt in _WORKLOAD_DTYPES.items():
        a = np.asarray(workload[k])
        if a.dtype != dt:
            raise TypeError(f"workload[{k!r}] is {a.dtype}, expected {np.dtype(dt)}")
        arrs[k] = a.copy()
    t = len(names)
    if arrs["parent_mask"].shape != (t, t) or arrs["work_ops"].shape != (t,):
        raise ValueError("workload arrays do not match the task names")
    if set(rows) != set(ROW_KEYS):
        raise KeyError(
            f"rows keys differ from ROW_KEYS: extra {sorted(set(rows) - set(ROW_KEYS))}, "
            f"missing {sorted(set(ROW_KEYS) - set(rows))}"
        )
    spec = alloc_rows(1, 1, 1, 1, 1, 1)
    for k in ROW_KEYS:
        a = np.asarray(rows[k])
        if a.dtype != spec[k].dtype or a.ndim != spec[k].ndim:
            raise TypeError(
                f"rows[{k!r}] is {a.dtype}{a.shape}, expected {spec[k].dtype} "
                f"with {spec[k].ndim} dims"
            )
    enc = EncodedWorkload(
        names=list(names), wl_names=list(wl_names),
        index={n: i for i, n in enumerate(names)}, **arrs,
    )
    return enc, rows_to({k: np.asarray(rows[k]) for k in ROW_KEYS}, device)


def phase_sim_plain(  # repro_torch: hot
    w: WorkloadTensors, rows: Dict[str, torch.Tensor], t_real: int
) -> Dict[str, torch.Tensor]:
    """Phase simulation + device-side Eq.-7 scoring of a batch of rows.

    The B axis is written out; the phase loop is a Python loop of
    ``t_real`` steps (every phase retires ≥ 1 live task, so ``t_real``
    suffice; once all are done, phases are zero-length no-ops). Tasks at
    index ≥ ``t_real`` are padding: born completed, they never run, never
    enter a share, and their zero work and bytes vanish in every sum.

    Contention sums are (T, T) co-residency reductions: ``task_pe`` and
    ``task_mem`` are phase-invariant, so the same-slot masks hoist out of
    the loop. NoC round-robin striping (Eq. 3) goes through rank residues —
    two running tasks share a link iff their running-order ranks are
    congruent mod ``n_links`` — with integer ranks, which are exact."""
    f32 = torch.float32
    i32 = torch.int32
    task_pe = rows["task_pe"].long()
    task_mem = rows["task_mem"].long()
    dev = task_pe.device
    b, t = task_pe.shape
    n_pe = rows["pe_peak"].shape[-1]
    n_mem = rows["mem_bw"].shape[-1]
    n_noc = rows["noc_bw"].shape[-1]
    noc_bw = rows["noc_bw"]
    work, rd_b, wr_b, burst = w.work_ops, w.read_bytes, w.write_bytes, w.burst

    # loop-invariant hoists: effective peak rates per task and the
    # same-slot co-residency masks behind Eq. 1/2 (PE share) and Eq. 4
    # (burst-proportional memory share)
    peak_eff = rows["pe_peak"].gather(1, task_pe) * rows["pe_accel"]
    mem_peak = rows["mem_bw"].gather(1, task_mem)
    same_pe = (task_pe[:, :, None] == task_pe[:, None, :]).to(f32)
    same_mem = (task_mem[:, :, None] == task_mem[:, None, :]).to(f32)
    onehot_pe = (task_pe[:, :, None] == torch.arange(n_pe, device=dev)).to(f32)
    onehot_mem = (task_mem[:, :, None] == torch.arange(n_mem, device=dev)).to(f32)
    links = rows["noc_links"].clamp(min=1)  # (B, N)
    # multi-NoC chain routing: a task's route is the chain-index interval
    # between its PE's and its MEM's NoC; hop count scales the NoC energy
    pe_pos = rows["pe_noc"].gather(1, task_pe)
    mem_pos = rows["mem_noc"].gather(1, task_mem)
    lo = torch.minimum(pe_pos, mem_pos)
    hi = torch.maximum(pe_pos, mem_pos)
    hops = (hi - lo + 1).to(f32)
    nidx = torch.arange(n_noc, device=dev)
    on_route = (nidx >= lo[:, :, None]) & (nidx <= hi[:, :, None])  # (B, T, N)
    lidx = torch.arange(8, device=dev)

    def noc_share(running, runf):
        """Eq. 3 per NoC: round-robin link striping, burst arbitration
        within the link; a task's end-to-end NoC bandwidth is the min over
        its route, and the first argmin in chain order is the binding NoC."""
        if n_noc == 1:
            order = torch.cumsum(running.to(i32), 1)
            resid = torch.remainder(
                order[:, :, None] - order[:, None, :], links[:, :1, None]
            ) == 0
            same_link = (runf[:, :, None] * runf[:, None, :]) * resid.to(f32)
            link_t = (same_link * burst).sum(-1)
            n_bw = noc_bw[:, :1] * burst / link_t.clamp(min=1e-30)
            return n_bw, torch.zeros((b, t), dtype=i32, device=dev)
        # multi-NoC: user u's link is (rank_u − 1) mod n_links, link loads
        # are one (8,) segment sum through a link one-hot (the link ladder
        # tops out at 8 channels)
        best = torch.full((b, t), BIG, dtype=f32, device=dev)
        arg = torch.zeros((b, t), dtype=i32, device=dev)
        for k in range(n_noc):
            use = on_route[:, :, k] & running
            order = torch.cumsum(use.to(i32), 1)
            link = torch.where(use, torch.remainder(order - 1, links[:, k:k + 1]), -1)
            oh = (link[:, :, None] == lidx).to(f32)  # (B, T, 8)
            link_load = ((burst * use.to(f32))[:, :, None] * oh).sum(1)  # (B, 8)
            link_t = (oh * link_load[:, None, :]).sum(-1)
            bw_k = torch.where(
                use, noc_bw[:, k:k + 1] * burst / link_t.clamp(min=1e-30), BIG
            )
            better = bw_k < best
            arg = torch.where(better, k, arg)
            best = torch.where(better, bw_k, best)
        return best, arg

    rem_ops = work.expand(b, t).clone()
    rem_rd = rd_b.expand(b, t).clone()
    rem_wr = wr_b.expand(b, t).clone()
    completed = (torch.arange(t, device=dev) >= t_real).expand(b, t).clone()
    now = torch.zeros(b, dtype=f32, device=dev)
    finish = torch.zeros((b, t), dtype=f32, device=dev)
    bneck = torch.zeros((b, t), dtype=i32, device=dev)
    bneck_noc = torch.zeros((b, t), dtype=i32, device=dev)
    kind_s = torch.zeros((b, 3), dtype=f32, device=dev)
    pe_bt = torch.zeros((b, t), dtype=f32, device=dev)
    mem_bt = torch.zeros((b, t), dtype=f32, device=dev)
    noc_bt = torch.zeros((b, n_noc), dtype=f32, device=dev)
    alp_t = torch.zeros(b, dtype=f32, device=dev)
    traffic = torch.zeros(b, dtype=f32, device=dev)
    nph = torch.zeros(b, dtype=i32, device=dev)
    parents = w.parent_mask[None]
    for _ in range(t_real):
        blocked = (parents & ~completed[:, None, :]).any(-1)
        running = ~completed & ~blocked
        runf = running.to(f32)
        burst_run = burst * runf

        # Eq. 1/2: preemptive equal share per PE slot
        load_t = (same_pe * runf[:, None, :]).sum(-1)
        compute = peak_eff / load_t.clamp(min=1.0)
        # Eq. 4: burst-proportional memory share (read/write channels split,
        # but they see identical shares — one bandwidth suffices)
        mem_t = (same_mem * burst_run[:, None, :]).sum(-1)
        m_bw = mem_peak * burst / mem_t.clamp(min=1e-30)
        # Eq. 3: per-NoC link striping, end-to-end min over the route
        n_bw, noc_arg = noc_share(running, runf)

        bw = torch.minimum(m_bw, n_bw)
        comp_t = rem_ops / compute
        comm_t = torch.maximum(rem_rd, rem_wr) / bw
        c_t = torch.where(running, torch.maximum(comp_t, comm_t), BIG)
        phi_raw = c_t.amin(1)  # Eq. 6
        any_run = phi_raw < BIG * 0.5
        phi = torch.where(any_run, phi_raw, 0.0)
        phi_run = torch.where(running, phi[:, None], 0.0)

        # binding resource per running task (total work over current rates;
        # compute wins ties, then mem vs noc by the tighter pipe)
        tot_comp_t = work / compute
        tot_comm_t = torch.maximum(rd_b, wr_b) / bw
        code = torch.where(
            tot_comp_t >= tot_comm_t, 0, torch.where(m_bw <= n_bw, 1, 2)
        ).to(i32)
        kind_s = kind_s + torch.stack(
            [torch.where(code == c, phi_run, 0.0).sum(1) for c in range(3)], 1
        )
        pe_bt = pe_bt + torch.where(code == 0, phi_run, 0.0)
        mem_bt = mem_bt + torch.where(code == 1, phi_run, 0.0)
        if n_noc > 1:  # the binding NoC varies per phase: resolve in-loop
            noc_bt = noc_bt + (
                torch.where(code == 2, phi_run, 0.0)[:, :, None]
                * (noc_arg[:, :, None] == nidx).to(f32)
            ).sum(1)

        # mask rates BEFORE the phi multiply: slots hosting no running task
        # price as inf bandwidth, and inf · 0 would poison the remains
        d_ops = torch.where(running, compute, 0.0) * phi[:, None]
        d_bw = torch.where(running, bw, 0.0) * phi[:, None]
        dr_ops = (rem_ops - d_ops).clamp(min=0.0)
        dr_rd = (rem_rd - d_bw).clamp(min=0.0)
        dr_wr = (rem_wr - d_bw).clamp(min=0.0)
        newly_done = running & (c_t <= phi[:, None] * RETIRE_SLACK)
        keep = ~newly_done
        now = now + phi
        finish = torch.where(newly_done, now[:, None], finish)
        bneck = torch.where(newly_done, code, bneck)
        if n_noc > 1:
            bneck_noc = torch.where(newly_done, noc_arg, bneck_noc)
        # busy-PE count: each PE with k running tasks contributes k · 1/k
        alp_t = alp_t + phi * (runf / load_t.clamp(min=1.0)).sum(1)
        traffic = traffic + torch.where(
            running, torch.minimum(dr_rd + dr_wr, d_bw + d_bw), 0.0
        ).sum(1)
        nph = nph + any_run.to(i32)
        rem_ops = torch.where(keep, dr_ops, 0.0)
        rem_rd = torch.where(keep, dr_rd, 0.0)
        rem_wr = torch.where(keep, dr_wr, 0.0)
        completed = completed | newly_done

    # per-block bottleneck telemetry: phi attribution resolved to the
    # binding slot (single-NoC chains resolve their one column from kind_s)
    pe_b = (pe_bt[:, :, None] * onehot_pe).sum(1)
    mem_b = (mem_bt[:, :, None] * onehot_mem).sum(1)
    noc_b = kind_s[:, 2:3] if n_noc == 1 else noc_bt

    # ---- PPA rollup + Eq.-7 fitness -------------------------------------
    wl_lat = torch.where(w.wl_hot[None], finish[:, :, None], 0.0).amax(1)
    dyn_pj = (
        rows["pe_pj"].gather(1, task_pe) * work
        + (rows["mem_pj"].gather(1, task_mem) + rows["noc_pj"][:, None] * hops)
        * (rd_b + wr_b)
    ).sum(1)
    # active-slot masked rollups (inactive slots price as absent hardware)
    leak_w = (
        (rows["pe_leak"] * rows["pe_active"]).sum(1)
        + (rows["mem_leak"] * rows["mem_active"]).sum(1)
        + (rows["noc_leak"] * rows["noc_active"]).sum(1)
    )
    energy = dyn_pj * 1e-12 + leak_w * now
    power = torch.where(now > 0, energy / now.clamp(min=1e-30), 0.0)
    cap = (wr_b[None, :, None] * onehot_mem).sum(1)
    area = (
        (rows["pe_area"] * rows["pe_active"]).sum(1)
        + (
            (rows["mem_area_fixed"] + rows["mem_area_per_mb"] * cap.clamp(min=1.0) / 1e6)
            * rows["mem_active"]
        ).sum(1)
        + (rows["noc_area"] * rows["noc_active"]).sum(1)
    )
    wl_bud = rows["wl_budget"]
    dists = torch.stack(
        [
            ((wl_lat - wl_bud) / wl_bud).amax(1),
            (power - rows["power_budget"]) / rows["power_budget"],
            (area - rows["area_budget"]) / rows["area_budget"],
        ],
        1,
    )
    fitness = torch.where(dists > 0, dists, rows["alpha"][:, None] * dists).sum(1)
    return {
        "latency_s": now,
        "finish_s": finish,
        "all_done": completed.all(1),
        # packed per-task binding code: 0 = pe, 1 = mem, 2 + 3·k = NoC at
        # chain index k (single-NoC packs to {0, 1, 2})
        "bneck_code": torch.where(bneck == 2, 2 + 3 * bneck_noc, bneck),
        "bneck_kind_s": kind_s,
        "pe_bneck_s": pe_b,
        "mem_bneck_s": mem_b,
        "noc_bneck_s": noc_b,
        "top_bneck_pe": pe_b.argmax(1).to(i32),
        "top_bneck_mem": mem_b.argmax(1).to(i32),
        "alp_time_s": alp_t,
        "traffic_bytes": traffic,
        "n_phases": nph,
        "wl_latency_s": wl_lat,
        "energy_j": energy,
        "power_w": power,
        "area_mm2": area,
        "fitness": fitness,
    }


def simulate_batch(
    enc: EncodedWorkload, rows: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Batched phase simulation + Eq.-7 scoring, in plain PyTorch.

    ``rows`` is a dict of per-design tensors (batch axis leading; see
    ``ROW_KEYS``/:func:`alloc_rows`), all on one device. Returns latency
    (B,), task finish times (B, T), the per-task / per-phase attribution the
    backend needs to lazily reconstruct a full ``SimResult`` (binding-
    resource code per task, bottleneck seconds, ALP time, traffic, phase
    count), the scalar PPA columns and the Eq.-7 ``fitness`` vector."""
    w = enc.on(rows["task_pe"].device)
    return phase_sim_plain(w, rows, len(enc.names))



def encode_batch(
    designs: List[Design],
    g: TaskGraph,
    db: HardwareDatabase,
    enc: EncodedWorkload,
    n_pe: int = 0,
    n_mem: int = 0,
    n_noc: int = 0,
) -> Dict[str, np.ndarray]:
    """Pad a list of designs to common slot/chain counts and stack into a
    :func:`simulate_batch` rows dict (neutral budget rows — callers that
    want device-side fitness fill them via :func:`fill_budget`).

    ``n_pe``/``n_mem``/``n_noc`` optionally force the padded counts —
    backends pad to shape buckets so buffers are keyed on a handful of shapes
    instead of one per block count a move walks through. Returns host
    (numpy) arrays; :func:`rows_to` moves them to a device.
    """
    encs = [EncodedDesign.of(d, g, db, enc) for d in designs]
    b, t = len(encs), len(enc.names)
    n_pe = max(n_pe, max(e.pe_peak.shape[0] for e in encs))
    n_mem = max(n_mem, max(e.mem_bw.shape[0] for e in encs))
    n_noc = max(n_noc, max(e.noc_bw.shape[0] for e in encs))
    rows = alloc_rows(b, t, n_pe, n_mem, len(enc.wl_names), n_noc)
    for i, e in enumerate(encs):
        fill_row(rows, i, e)
    return rows
