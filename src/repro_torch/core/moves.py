"""Optimization moves (paper §3.3, Fig. 6, Table 3).

Three primitives plus a composite, all *incremental* (one knob, one step, one
task at a time — the development-cost policy) and *symmetric* (every move has
an inverse, enabling backtracking):

  swap      — customization: step one knob one rung, or GPP↔Acc conversion
  fork      — allocation: duplicate a block, migrate some load over
  join      — allocation⁻¹: merge a block into a sibling, delete it
  migrate   — mapping: move one task (or its buffer) to another block
  fork_swap — fork followed by swap ("introduced to accelerate navigation")

Every function mutates ``design`` in place (the explorer clones first) and
returns True on success / False when the move is inapplicable (ladder end
stop, last block of a kind, ...). Failed moves cost nothing and let the
explorer fall through its precedence list.
"""
from __future__ import annotations

import copy
import dataclasses
import random
from typing import Dict, List, Optional

from .blocks import Block, BlockKind, make_noc
from .design import Design
from .tdg import TaskGraph

MOVE_KINDS = ("swap", "fork", "join", "migrate", "fork_swap")


@dataclasses.dataclass(frozen=True)
class MoveSpec:
    """The 5-tuple a move application needs — a candidate neighbour is
    (base design, spec), replayable deterministically via :func:`apply_move`
    (moves never consume the RNG), so the full ``Design`` object is only
    materialized for the candidate the explorer accepts."""

    move: str
    block: Optional[str]
    task: Optional[str]
    direction: int
    bottleneck: str
    objective: str


@dataclasses.dataclass
class MoveDelta:
    """Encoding delta emitted by a move: exactly what changed, in terms the
    flat-array design encoding understands (``phase_sim_torch.apply_delta``
    turns one into an :class:`~repro_torch.core.phase_sim_torch.EncodedDesign`
    without re-encoding the whole design).

    ``touched`` holds post-move knob *snapshots* (shallow copies) because the
    design itself is rolled back after the trial; ``added`` holds the new
    Block objects themselves — rollback detaches them from the design, after
    which nothing mutates them. ``attached`` records NoC-attachment edits
    (block → NoC name) for both newly added PE/MEM blocks and blocks a NoC
    fork/join re-homed; ``noc_after`` records where an added NoC was inserted
    in the chain (the predecessor's name). Together with ``removed`` they make
    topology moves fully replayable against the flat encoding — NoC fork/join
    emit ordinary deltas and ride the vectorized path. ``topology`` remains
    as the escape hatch for edits the encoding cannot host (no built-in move
    sets it anymore; a True value forces the scalar Python fallback)."""

    task_pe: Dict[str, str] = dataclasses.field(default_factory=dict)
    task_mem: Dict[str, str] = dataclasses.field(default_factory=dict)
    touched: Dict[str, Block] = dataclasses.field(default_factory=dict)
    added: List[Block] = dataclasses.field(default_factory=list)
    removed: List[str] = dataclasses.field(default_factory=list)
    attached: Dict[str, str] = dataclasses.field(default_factory=dict)
    noc_after: Optional[str] = None
    topology: bool = False

    def touch(self, block: Block) -> None:
        self.touched[block.name] = copy.copy(block)
# Development-cost precedence (paper Algorithm 1, step II):
#   join > migrate > fork > swap > fork_swap
MOVE_PRECEDENCE = {"join": 5, "migrate": 4, "fork": 3, "swap": 2, "fork_swap": 1}
# software-to-hardware mapping & allocation are "high-level" optimizations,
# knob tuning is "low-level" (paper §5.3 co-design vectors)
HIGH_LEVEL = {"migrate", "fork", "join", "fork_swap"}


# ---------------------------------------------------------------------------
# swap
# ---------------------------------------------------------------------------
def _knob_candidates(block: Block, task, direction: int) -> List[str]:
    """Which knobs a swap may step on this block, in preference order."""
    if block.kind == BlockKind.PE:
        if block.subtype == "acc":
            # prefer unrolling while the task still has LLP headroom
            if task is not None and direction > 0 and block.unroll < task.llp:
                return ["unroll", "freq_mhz"]
            return ["freq_mhz", "unroll"]
        return ["freq_mhz"]
    if block.kind == BlockKind.NOC:
        return ["width_bytes", "freq_mhz", "n_links"]
    return ["width_bytes", "freq_mhz"]  # MEM


def apply_swap(
    design: Design,
    tdg: TaskGraph,
    block_name: str,
    direction: int,
    task_name: Optional[str] = None,
    rng: Optional[random.Random] = None,
    delta: Optional[MoveDelta] = None,
) -> bool:
    """Step one knob one rung (incremental customization). ``direction=+1``
    buys performance, ``-1`` returns it (power/area). GPP→Acc hardening
    happens when the PE hosts exactly the target task (otherwise the explorer
    reaches hardening via fork_swap); Acc→GPP is the symmetric inverse.
    Mem swap also flips DRAM↔SRAM: SRAM saves energy/byte, DRAM saves area."""
    rng = rng or random.Random(0)
    block = design.blocks[block_name]
    task = tdg.tasks.get(task_name) if task_name else None

    def done() -> bool:
        if delta is not None:
            delta.touch(block)
        return True

    # subtype conversions first (the "real" customization)
    if block.kind == BlockKind.PE and direction > 0 and block.subtype == "gpp":
        hosted = design.tasks_on_pe(block_name)
        if task_name and hosted == [task_name]:
            block.subtype = "acc"
            block.hardened_for = task_name
            return done()
    if block.kind == BlockKind.PE and direction < 0 and block.subtype == "acc":
        # soften: cheaper to develop, slower (symmetric inverse of hardening)
        if block.unroll > 1:
            return block.step_knob("unroll", -1) and done()
        block.subtype = "gpp"
        block.hardened_for = None
        return done()
    if block.kind == BlockKind.MEM:
        # energy pressure → SRAM; area pressure → DRAM (§6.1 memory study)
        if direction < 0 and block.subtype == "dram":
            block.subtype = "sram"
            return done()

    knobs = _knob_candidates(block, task, direction)
    for knob in knobs:
        if block.step_knob(knob, direction):
            return done()
    if block.kind == BlockKind.MEM and direction > 0 and block.subtype == "sram":
        block.subtype = "dram"  # ladder exhausted: trade energy for capacity
        return done()
    return False


# ---------------------------------------------------------------------------
# fork / join
# ---------------------------------------------------------------------------
def apply_fork(
    design: Design,
    tdg: TaskGraph,
    block_name: str,
    task_name: Optional[str] = None,
    rng: Optional[random.Random] = None,
    delta: Optional[MoveDelta] = None,
) -> bool:
    """Duplicate ``block`` and migrate load over: the target task (if given)
    or every other task/buffer. For NoCs the new router is inserted next in
    the chain and takes half the attached PEs/Mems (congestion relief)."""
    rng = rng or random.Random(0)
    block = design.blocks[block_name]

    if block.kind == BlockKind.NOC:
        attached = design.attached(block_name)
        if len(attached) < 2:
            return False
        new = make_noc(block.freq_mhz, block.width_bytes, block.n_links)
        design.add_block(new, after_noc=block_name)
        for b in attached[1::2]:
            design.attached_noc[b] = new.name
        if delta is not None:
            delta.added.append(new)
            delta.noc_after = block_name  # chain insertion point
            for b in attached[1::2]:
                delta.attached[b] = new.name
        return True

    hosted = (
        design.tasks_on_pe(block_name)
        if block.kind == BlockKind.PE
        else design.buffers_on_mem(block_name)
    )
    if len(hosted) < 2:
        return False  # duplication must *split* load, never orphan the source
    if task_name == hosted[0]:
        # the anchor task must stay: an explicit request to migrate it is
        # inapplicable — refuse rather than silently moving a different task
        return False
    movers = [task_name] if (task_name in hosted) else hosted[1::2]
    clone = block.clone()
    if clone.subtype == "acc" and task_name and task_name != block.hardened_for:
        clone.hardened_for = task_name  # duplicated IP hardened for the mover
    design.add_block(clone, attach_to=design.attached_noc[block_name])
    target_map = design.task_pe if block.kind == BlockKind.PE else design.task_mem
    for t in movers:
        target_map[t] = clone.name
    if delta is not None:
        delta.added.append(clone)
        delta.attached[clone.name] = design.attached_noc[block_name]
        moved = delta.task_pe if block.kind == BlockKind.PE else delta.task_mem
        for t in movers:
            moved[t] = clone.name
    return True


def apply_join(
    design: Design,
    tdg: TaskGraph,
    block_name: str,
    rng: Optional[random.Random] = None,
    delta: Optional[MoveDelta] = None,
) -> bool:
    """Merge ``block`` into a sibling and delete it (the inverse of fork;
    the highest-precedence move because it *removes* hardware)."""
    rng = rng or random.Random(0)
    block = design.blocks.get(block_name)
    if block is None:
        return False

    if block.kind == BlockKind.NOC:
        if len(design.noc_chain) < 2:
            return False
        idx = design.noc_chain.index(block_name)
        target = design.noc_chain[idx - 1] if idx > 0 else design.noc_chain[1]
        for b in design.attached(block_name):
            design.attached_noc[b] = target
            if delta is not None:
                delta.attached[b] = target
        design.remove_block(block_name)
        if delta is not None:
            delta.removed.append(block_name)
        return True

    siblings = [
        n
        for n, b in design.blocks.items()
        if n != block_name and b.kind == block.kind
    ]
    if not siblings:
        return False
    # prefer a sibling on the same NoC (locality), then a GPP for PE joins
    same_noc = [s for s in siblings if design.attached_noc[s] == design.attached_noc[block_name]]
    pool = same_noc or siblings
    if block.kind == BlockKind.PE:
        gpps = [s for s in pool if design.blocks[s].subtype == "gpp"]
        target = (gpps or pool)[0]
        for t in design.tasks_on_pe(block_name):
            design.task_pe[t] = target
            if delta is not None:
                delta.task_pe[t] = target
    else:
        target = pool[0]
        for t in design.buffers_on_mem(block_name):
            design.task_mem[t] = target
            if delta is not None:
                delta.task_mem[t] = target
    design.remove_block(block_name)
    if delta is not None:
        delta.removed.append(block_name)
    return True


# ---------------------------------------------------------------------------
# migrate
# ---------------------------------------------------------------------------
def apply_migrate(
    design: Design,
    tdg: TaskGraph,
    task_name: str,
    bottleneck: str = "pe",
    rng: Optional[random.Random] = None,
    objective: str = "latency",
    delta: Optional[MoveDelta] = None,
) -> bool:
    """Move one task (compute-bound → new PE) or its buffer (comm-bound →
    new MEM) — mapping change. Destination is chosen with architectural
    reasoning: load balancing for latency (least-loaded candidate), spatial
    locality (same-NoC placement, fewer hops), consolidation for power/area
    (paper §3.3 'Using Architectural Reasoning for Move Selection')."""
    rng = rng or random.Random(0)

    if bottleneck in ("mem", "noc"):
        cur = design.task_mem[task_name]
        cands = [m for m in design.mems() if m != cur]
        if not cands:
            return False
        pe_noc = design.attached_noc[design.task_pe[task_name]]
        if objective == "latency":
            # locality: fewest hops to the task's PE, then least congested
            def key(m):
                i = design.noc_chain.index(design.attached_noc[m])
                j = design.noc_chain.index(pe_noc)
                return (abs(i - j), len(design.buffers_on_mem(m)))
        else:
            # consolidation: the busiest memory (lets joins follow)
            def key(m):
                return -len(design.buffers_on_mem(m))
        design.task_mem[task_name] = min(cands, key=key)
        if delta is not None:
            delta.task_mem[task_name] = design.task_mem[task_name]
        return True

    cur = design.task_pe[task_name]
    cands = [p for p in design.pes() if p != cur]
    # an accelerator hardened for another task would run this task at a=1;
    # still legal (paper migrates freely) but de-prioritized by the key below
    if not cands:
        return False
    mem_noc = design.attached_noc[design.task_mem[task_name]]

    def pe_key(p):
        b = design.blocks[p]
        hardened = b.subtype == "acc" and b.hardened_for == task_name
        i = design.noc_chain.index(design.attached_noc[p])
        j = design.noc_chain.index(mem_noc)
        if objective == "latency":
            return (not hardened, len(design.tasks_on_pe(p)), abs(i - j))
        return (-len(design.tasks_on_pe(p)), not hardened)

    design.task_pe[task_name] = min(cands, key=pe_key)
    if delta is not None:
        delta.task_pe[task_name] = design.task_pe[task_name]
    return True


# ---------------------------------------------------------------------------
# composite
# ---------------------------------------------------------------------------
def apply_fork_swap(
    design: Design,
    tdg: TaskGraph,
    block_name: str,
    task_name: Optional[str],
    direction: int,
    rng: Optional[random.Random] = None,
    delta: Optional[MoveDelta] = None,
) -> bool:
    """Fork then swap the forked block up — the paper's shortcut for
    'dedicate new hardware to this task and customize it'."""
    rng = rng or random.Random(0)
    before = set(design.blocks)
    if not apply_fork(design, tdg, block_name, task_name, rng, delta):
        return False
    new_block = next(iter(set(design.blocks) - before), None)
    if new_block is None:
        return False
    # the swap's touch snapshot is redundant for a just-added block (the
    # delta's `added` ref is the same live object) but harmless
    apply_swap(design, tdg, new_block, direction, task_name, rng, delta)
    return True


def apply_move(
    design: Design,
    tdg: TaskGraph,
    move: str,
    block_name: Optional[str],
    task_name: Optional[str],
    direction: int,
    bottleneck: str,
    objective: str,
    rng: random.Random,
    delta: Optional[MoveDelta] = None,
) -> bool:
    if move == "swap":
        return apply_swap(design, tdg, block_name, direction, task_name, rng, delta)
    if move == "fork":
        return apply_fork(design, tdg, block_name, task_name, rng, delta)
    if move == "join":
        return apply_join(design, tdg, block_name, rng, delta)
    if move == "migrate":
        return apply_migrate(design, tdg, task_name, bottleneck, rng, objective, delta)
    if move == "fork_swap":
        return apply_fork_swap(design, tdg, block_name, task_name, direction, rng, delta)
    raise KeyError(move)


def apply_spec(
    design: Design,
    tdg: TaskGraph,
    spec: MoveSpec,
    rng: Optional[random.Random] = None,
    delta: Optional[MoveDelta] = None,
) -> bool:
    """Replay a recorded move 5-tuple (moves are deterministic given the
    design state, so a spec applied to the same base reproduces the same
    neighbour bit-for-bit)."""
    return apply_move(
        design, tdg, spec.move, spec.block, spec.task, spec.direction,
        spec.bottleneck, spec.objective, rng or random.Random(0), delta,
    )


# ---------------------------------------------------------------------------
# array-packable deltas (device-resident exploration)
# ---------------------------------------------------------------------------
def mapping_delta(
    task_pe: Dict[str, str], task_mem: Dict[str, str]
) -> MoveDelta:
    """A :class:`MoveDelta` for a pure mapping change with *absolute*
    destinations — the form a packed device move table stores. A relative
    migrate (:func:`apply_migrate`) reasons about the current design to pick
    a destination; the device loop instead enumerates every
    (task, destination-slot) pair up front as packed int32 arrays
    (``device_explore.MoveTable``) and samples among them on device, so an
    accepted move comes back as concrete (task → block-name) assignments.
    Shape-preserving by construction: no blocks added, removed, or touched,
    so the delta always rides the vectorized encoding path."""
    d = MoveDelta()
    d.task_pe.update(task_pe)
    d.task_mem.update(task_mem)
    return d


def apply_mapping(
    design: Design,
    task_pe: Dict[str, str],
    task_mem: Dict[str, str],
    delta: Optional[MoveDelta] = None,
) -> bool:
    """Apply absolute task→block assignments onto ``design`` in place — the
    host-side reconcile primitive for device-accepted packed moves (the
    winning chain's final mapping is a batch of these). Returns False
    without mutating anything if any named task or block is unknown."""
    for t, p in task_pe.items():
        if t not in design.task_pe or p not in design.blocks:
            return False
    for t, m in task_mem.items():
        if t not in design.task_mem or m not in design.blocks:
            return False
    for t, p in task_pe.items():
        design.task_pe[t] = p
        if delta is not None:
            delta.task_pe[t] = p
    for t, m in task_mem.items():
        design.task_mem[t] = m
        if delta is not None:
            delta.task_mem[t] = m
    return True


# ---------------------------------------------------------------------------
# Allocation bridge: host-side reconcile primitives for device-accepted
# allocation moves. A device chain block mutates padded slot inventories
# (active masks + per-slot coefficient columns, ``device_explore.ChainCarry``)
# instead of the Design's dict shape; when the explorer adopts a winning
# chain, ``device_explore.reconcile_alloc`` replays that platform onto the
# live Design through these four primitives — clone-and-attach for forked
# slots, removal for joined slots, a frequency retune for stepped rungs, and
# a NoC re-home for attach moves. Each is shape-changing on the HOST design
# (that is the point: the shape change happens once per adopted block, not
# once per SA iteration).


def fork_block(
    design: Design, origin: str, *, freq_mhz: int, noc: str
) -> str:
    """Clone ``origin`` (same subtype/width/unroll/hardening — the device
    fork copies the source slot's coefficient columns, so the host clone
    must inherit the same knobs), retune it to ``freq_mhz``, attach it to
    ``noc``, and return the new block's (fresh, uid-suffixed) name."""
    b = design.blocks[origin].clone()
    b.freq_mhz = freq_mhz
    design.add_block(b, attach_to=noc)
    return b.name


def join_block(design: Design, name: str) -> None:
    """Remove a block the device loop joined away (or whose slot the winner
    re-populated with a clone). The caller must have re-mapped every task
    off it first — device join validity guarantees the slot was empty."""
    assert name not in design.task_pe.values(), f"{name} still hosts tasks"
    assert name not in design.task_mem.values(), f"{name} still hosts buffers"
    design.remove_block(name)


def retune_block(design: Design, name: str, freq_mhz: int) -> None:
    """Set a block's frequency knob to the ladder value the device swap
    moves walked it to (``FREQ_LADDER_MHZ[rung]``)."""
    assert freq_mhz in design.blocks[name].ladder("freq_mhz"), freq_mhz
    design.blocks[name].freq_mhz = freq_mhz


def attach_block(design: Design, name: str, noc: str) -> None:
    """Re-home a PE/MEM block to another NoC chain position (the device
    NoC-attach move)."""
    assert noc in design.noc_chain, noc
    design.attached_noc[name] = noc
