"""Single source of truth for the packed scal column layout.

One dispatch crosses the host boundary as a single ``(B, N_SCAL + 2·S + N)``
matrix (``backend._TorchBatch``). The CUDA phase-sim kernel writes that block
itself, in this column order, and the plain version's packing
(``kernels/phase_sim/ops.py``) derives from the same tuple, so this module is
the one place a scal column is named.

Layout: the 9 host-unpack scalars first (``SCAL_PREFIX`` — what
``backend._SCAL_COLS`` exposes as named host columns), then the
comp-vs-comm kind split triple, then the top-bottleneck slot pair. The
variable-width per-slot telemetry tail (``pe_bneck_s``/``mem_bneck_s``/
``noc_bneck_s``) rides after ``N_SCAL`` and is split on host from the
batch's recorded ``(S, N)`` dims — it never gets column names here.

This module must stay dependency-free (no torch, no numpy): it is imported
by both ``core.backend`` and ``kernels.phase_sim.kernel``, in either
order, possibly mid-package-initialization.
"""

# the named host-unpack scalars (backend._SCAL_COLS)
SCAL_PREFIX = (
    "latency_s", "energy_j", "power_w", "area_mm2", "fitness",
    "alp_time_s", "traffic_bytes", "n_phases", "all_done",
)

# comp-vs-comm attribution split (backend unpacks the triple as one
# ``bneck_kind_s`` (B, 3) column block)
BNECK_KIND_COLS = ("kind_pe_s", "kind_mem_s", "kind_noc_s")

# argmax slots of the per-block bottleneck-seconds telemetry — the block a
# bottleneck-relaxation policy should target next, computed on device
TOP_BNECK_COLS = ("top_bneck_pe", "top_bneck_mem")

# the full fixed-width block, in kernel write order
SCAL_COLS = SCAL_PREFIX + BNECK_KIND_COLS + TOP_BNECK_COLS
N_SCAL = len(SCAL_COLS)

# host-unpack indices (backend._TorchBatch.host) — derived, never hardcoded
KIND_START = len(SCAL_PREFIX)
KIND_STOP = KIND_START + len(BNECK_KIND_COLS)
TOP_PE_COL = KIND_STOP
TOP_MEM_COL = TOP_PE_COL + 1
