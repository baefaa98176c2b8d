"""Hardware block abstractions (paper §3.2, Table 2/3).

A *block* is the lowest abstraction unit of the system simulator: a processing
element (general-purpose processor or accelerator IP), a memory (DRAM/SRAM),
or a NoC (bus/router with ``width × freq`` bandwidth and ``links`` channels).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

_uid = itertools.count()


class BlockKind(str, enum.Enum):
    PE = "pe"
    MEM = "mem"
    NOC = "noc"


# Knob ladders (paper Table 3). Swap moves step one rung at a time so that a
# move "only incrementally modifies the original block".
FREQ_LADDER_MHZ = (100, 200, 300, 400, 500, 600, 700, 800)
WIDTH_LADDER_BYTES = (4, 8, 16, 32, 64, 128, 256)
LINK_LADDER = (1, 2, 4, 8)
# Accelerator loop-unrolling ladder (Table 3: "Loop Unrolling — according to
# the task"; the effective factor is capped by the task's LLP at pricing time).
UNROLL_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass
class Block:
    """One hardware block instance and its knob settings."""

    kind: BlockKind
    subtype: str  # PE: "gpp"|"acc"; MEM: "dram"|"sram"; NOC: "noc"
    freq_mhz: int = 100
    width_bytes: int = 32  # NoC / Mem bus width
    n_links: int = 1  # NoC channels
    unroll: int = 1  # accelerator datapath parallelism (PE subtype "acc")
    # For accelerators: which task this IP is hardened for (A_peak lives in the
    # database, keyed by (task_name, subtype)).
    hardened_for: Optional[str] = None
    name: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            self.name = f"{self.subtype}_{next(_uid)}"

    # ---- peak rates (Gables "peak" terms) ------------------------------
    def peak_compute_ops(self, database) -> float:
        """P_peak for a PE in ops/sec (Eq. 1/2 numerator)."""
        assert self.kind == BlockKind.PE
        return database.pe_peak_ops(self)

    def peak_bandwidth(self, database) -> float:
        """B_peak for MEM/NOC in bytes/sec (per channel for NoCs)."""
        assert self.kind in (BlockKind.MEM, BlockKind.NOC)
        return self.freq_mhz * 1e6 * self.width_bytes

    # ---- knob manipulation (swap move substrate) -----------------------
    def ladder(self, knob: str):
        if knob == "freq_mhz":
            return FREQ_LADDER_MHZ
        if knob == "width_bytes":
            return WIDTH_LADDER_BYTES
        if knob == "n_links":
            return LINK_LADDER
        if knob == "unroll":
            return UNROLL_LADDER
        raise KeyError(knob)

    def step_knob(self, knob: str, direction: int) -> bool:
        """Move one rung along a knob ladder. Returns False at the end stop."""
        ladder = self.ladder(knob)
        cur = getattr(self, knob)
        idx = ladder.index(cur)
        new = idx + direction
        if not (0 <= new < len(ladder)):
            return False
        setattr(self, knob, ladder[new])
        return True

    def clone(self) -> "Block":
        return Block(
            kind=self.kind,
            subtype=self.subtype,
            freq_mhz=self.freq_mhz,
            width_bytes=self.width_bytes,
            n_links=self.n_links,
            unroll=self.unroll,
            hardened_for=self.hardened_for,
        )

    def signature(self) -> tuple:
        """Hashable knob state (used for heterogeneity / CV statistics)."""
        return (
            self.kind.value,
            self.subtype,
            self.freq_mhz,
            self.width_bytes,
            self.n_links,
            self.unroll,
            self.hardened_for,
        )


def make_gpp(freq_mhz: int = 100) -> Block:
    return Block(kind=BlockKind.PE, subtype="gpp", freq_mhz=freq_mhz)


def make_accelerator(task_name: str, freq_mhz: int = 100) -> Block:
    return Block(
        kind=BlockKind.PE, subtype="acc", freq_mhz=freq_mhz, hardened_for=task_name
    )


def make_mem(subtype: str = "dram", freq_mhz: int = 100, width_bytes: int = 32) -> Block:
    return Block(kind=BlockKind.MEM, subtype=subtype, freq_mhz=freq_mhz, width_bytes=width_bytes)


def make_noc(freq_mhz: int = 100, width_bytes: int = 32, n_links: int = 1) -> Block:
    return Block(
        kind=BlockKind.NOC,
        subtype="noc",
        freq_mhz=freq_mhz,
        width_bytes=width_bytes,
        n_links=n_links,
    )
