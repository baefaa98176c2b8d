"""A *design* = hardware blocks + topology + software→hardware mapping.

Topology model (paper §3.2 "many NoC" systems): NoCs form a chain (a bus
hierarchy); every PE and every MEM attaches to exactly one NoC. The route of a
(task, buffer) pair is the NoC sub-chain between the task's PE and the buffer's
MEM; every NoC on the route carries the traffic (multi-hop congestion, spatial
locality = short routes).

FARSI starts from the simplest base design — one GPP, one NoC, one DRAM
(paper §3.3 "Development-cost Awareness") — and grows it incrementally via
moves.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

from .blocks import Block, BlockKind, make_gpp, make_mem, make_noc
from .tdg import TaskGraph


@dataclasses.dataclass
class DesignCheckpoint:
    """Cheap snapshot of a :class:`Design` for in-place move trial/rollback.

    The DSE hot loop applies a candidate move to the *current* design, encodes
    the result, and rolls back — no Python object graph is cloned per
    neighbour (the paper's Fig.-8b hot-spot). Block objects are shared with
    the design; only their mutable knob fields are snapshotted, so restore is
    a handful of dict copies plus one attribute sweep."""

    blocks: Dict[str, Block]
    noc_chain: List[str]
    attached_noc: Dict[str, str]
    task_pe: Dict[str, str]
    task_mem: Dict[str, str]
    block_states: List[Tuple[Block, str, int, int, int, int, Optional[str]]]


class Design:
    def __init__(self) -> None:
        self.blocks: Dict[str, Block] = {}
        self.noc_chain: List[str] = []  # ordered NoC names
        self.attached_noc: Dict[str, str] = {}  # PE/MEM name -> NoC name
        self.task_pe: Dict[str, str] = {}  # task -> PE name
        self.task_mem: Dict[str, str] = {}  # task buffer -> MEM name

    # ------------------------------------------------------------------
    @staticmethod
    def base(tdg: TaskGraph) -> "Design":
        """One GPP + one NoC + one DRAM; all tasks on the GPP, all buffers in
        DRAM (paper: 'FARSI starts with a very simple base design')."""
        d = Design()
        noc = d.add_block(make_noc())
        pe = d.add_block(make_gpp(), attach_to=noc.name)
        mem = d.add_block(make_mem("dram"), attach_to=noc.name)
        for t in tdg.tasks:
            d.task_pe[t] = pe.name
            d.task_mem[t] = mem.name
        return d

    # ---- block/topology editing ---------------------------------------
    def add_block(self, block: Block, attach_to: Optional[str] = None,
                  after_noc: Optional[str] = None) -> Block:
        self.blocks[block.name] = block
        if block.kind == BlockKind.NOC:
            if after_noc is None:
                self.noc_chain.append(block.name)
            else:
                self.noc_chain.insert(self.noc_chain.index(after_noc) + 1, block.name)
        else:
            assert attach_to is not None and self.blocks[attach_to].kind == BlockKind.NOC
            self.attached_noc[block.name] = attach_to
        return block

    def remove_block(self, name: str) -> None:
        blk = self.blocks.pop(name)
        if blk.kind == BlockKind.NOC:
            self.noc_chain.remove(name)
        else:
            self.attached_noc.pop(name)

    def rename_block(self, old: str, new: str) -> None:
        """Rename a block in place, preserving its insertion-order slot (slot
        order is what the flat encoding keys on). Used to make move replays
        name-deterministic: a replayed fork re-clones the block under a fresh
        uid, and the caller renames it back to the recorded one."""
        assert new not in self.blocks, (old, new)
        blk = self.blocks[old]
        blk.name = new
        self.blocks = {(new if k == old else k): v for k, v in self.blocks.items()}
        self.noc_chain = [new if n == old else n for n in self.noc_chain]
        self.attached_noc = {
            (new if k == old else k): (new if v == old else v)
            for k, v in self.attached_noc.items()
        }
        for m in (self.task_pe, self.task_mem):
            for t, b in m.items():
                if b == old:
                    m[t] = new

    def pes(self) -> List[str]:
        return [n for n, b in self.blocks.items() if b.kind == BlockKind.PE]

    def mems(self) -> List[str]:
        return [n for n, b in self.blocks.items() if b.kind == BlockKind.MEM]

    def nocs(self) -> List[str]:
        return list(self.noc_chain)

    def attached(self, noc_name: str) -> List[str]:
        return [n for n, c in self.attached_noc.items() if c == noc_name]

    # ---- routing -------------------------------------------------------
    def route(self, task: str) -> List[str]:
        """NoC names on the PE→MEM path of ``task`` (inclusive)."""
        pe_noc = self.attached_noc[self.task_pe[task]]
        mem_noc = self.attached_noc[self.task_mem[task]]
        i, j = self.noc_chain.index(pe_noc), self.noc_chain.index(mem_noc)
        lo, hi = min(i, j), max(i, j)
        return self.noc_chain[lo:hi + 1]

    def hops(self, task: str) -> int:
        return len(self.route(task))

    # ---- bookkeeping ----------------------------------------------------
    def tasks_on_pe(self, pe: str) -> List[str]:
        return [t for t, p in self.task_pe.items() if p == pe]

    def buffers_on_mem(self, mem: str) -> List[str]:
        return [t for t, m in self.task_mem.items() if m == mem]

    def tasks_via_noc(self, noc: str) -> List[str]:
        return [t for t in self.task_pe if noc in self.route(t)]

    def clone(self, rename: bool = True) -> "Design":
        """Design duplication — the paper's own profiled hot-spot (Fig. 8b:
        79.9% of generation time). We keep it cheap: blocks are shallow-copied
        via their own ``clone`` and mappings are dict copies (no generic
        deepcopy). ``rename=False`` keeps block names stable so results priced
        against the original still resolve (explorer best-design snapshots).
        The DSE inner loop avoids cloning entirely via
        :meth:`checkpoint`/:meth:`restore` + flat-array neighbour encodings
        (``core/phase_sim_torch.py``)."""
        d = Design.__new__(Design)
        d.blocks = {}
        names: Dict[str, str] = {}
        for name, b in self.blocks.items():
            nb = b.clone()
            if not rename:
                nb.name = name
            names[name] = nb.name
            d.blocks[nb.name] = nb
        d.noc_chain = [names[n] for n in self.noc_chain]
        d.attached_noc = {names[k]: names[v] for k, v in self.attached_noc.items()}
        d.task_pe = {t: names[p] for t, p in self.task_pe.items()}
        d.task_mem = {t: names[m] for t, m in self.task_mem.items()}
        return d

    # ---- in-place trial/rollback (clone-free neighbour generation) ------
    def checkpoint(self) -> DesignCheckpoint:
        """Snapshot for :meth:`restore`. O(blocks + tasks) dict/tuple copies,
        no Block construction — the whole point versus :meth:`clone`."""
        return DesignCheckpoint(
            blocks=dict(self.blocks),
            noc_chain=list(self.noc_chain),
            attached_noc=dict(self.attached_noc),
            task_pe=dict(self.task_pe),
            task_mem=dict(self.task_mem),
            block_states=[
                (b, b.subtype, b.freq_mhz, b.width_bytes, b.n_links, b.unroll,
                 b.hardened_for)
                for b in self.blocks.values()
            ],
        )

    def restore(self, ck: DesignCheckpoint) -> None:
        """Undo every mutation since ``ck`` was taken: topology, mappings, and
        knob edits on blocks that existed then. Blocks added afterwards are
        dropped (any captured references stay valid but detached)."""
        self.blocks = dict(ck.blocks)
        self.noc_chain = list(ck.noc_chain)
        self.attached_noc = dict(ck.attached_noc)
        self.task_pe = dict(ck.task_pe)
        self.task_mem = dict(ck.task_mem)
        for b, subtype, freq, width, links, unroll, hardened in ck.block_states:
            b.subtype = subtype
            b.freq_mhz = freq
            b.width_bytes = width
            b.n_links = links
            b.unroll = unroll
            b.hardened_for = hardened

    def deep_clone_reference(self) -> "Design":
        """Naive ``copy.deepcopy`` clone, kept as the reference the paper
        profiles against (benchmarks/bench_generation.py measures both)."""
        return copy.deepcopy(self)

    # ---- complexity metrics (paper §6.1) --------------------------------
    def block_counts(self) -> Dict[str, int]:
        return {
            "pe": len(self.pes()),
            "mem": len(self.mems()),
            "noc": len(self.nocs()),
        }

    def heterogeneity_cv(self, kind: BlockKind, knob: str) -> float:
        """Coefficient of variation of a knob across blocks of one kind —
        the paper's system-heterogeneity metric (Fig. 15)."""
        vals = [getattr(b, knob) for b in self.blocks.values() if b.kind == kind]
        if len(vals) < 2:
            return 0.0
        mean = sum(vals) / len(vals)
        if mean == 0:
            return 0.0
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        return (var ** 0.5) / mean

    # knob axes the development-cost variation metric averages over: one CV
    # per (kind, knob) pair the swap ladders actually walk
    _VARIATION_AXES = (
        (BlockKind.PE, "freq_mhz"), (BlockKind.PE, "unroll"),
        (BlockKind.MEM, "freq_mhz"), (BlockKind.MEM, "width_bytes"),
        (BlockKind.NOC, "freq_mhz"), (BlockKind.NOC, "width_bytes"),
    )

    def complexity_metrics(self) -> Dict[str, float]:
        """The paper's §5.3/§6.1 development-cost pair: total component
        count and system variation (mean heterogeneity CV over the knob
        ladders), plus the NoC-subsystem component count the §5.3 NoC
        simplification result is stated in."""
        return {
            "components": float(len(self.blocks)),
            "noc_components": float(len(self.noc_chain)),
            "variation": sum(
                self.heterogeneity_cv(k, knob) for k, knob in self._VARIATION_AXES
            ) / len(self._VARIATION_AXES),
        }

    def signature(self) -> tuple:
        return (
            tuple(sorted(b.signature() for b in self.blocks.values())),
            tuple(sorted(self.task_pe.items())),
            tuple(sorted(self.task_mem.items())),
        )
