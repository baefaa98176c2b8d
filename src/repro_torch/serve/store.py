"""Content-addressed design-evaluation cache (the serve layer's database).

``core/database.py`` hashes task *names* into stable units
(``_stable_unit``); this module generalizes the idiom to whole evaluations:
the cache key is a SHA-256 digest over the **content** of a candidate's
flat :class:`~repro_torch.core.phase_sim_torch.EncodedDesign` leaves (every array
the device row is filled from, plus ``noc_pj``), the workload's encoded
tensors, and the Eq.-7 budget/alpha the dispatch would score against. Two
candidates with identical digests produce bit-identical device rows, so the
second one can be served from the first one's memoized output row without a
dispatch — across sessions, across users, across time.

The store deliberately knows nothing about torch or the backend beyond two
duck-typed facts:

  * a *pending* entry holds ``(batch, j)`` where ``batch.host()`` yields the
    dispatch's host-side column dict (the backend registers every dispatched
    row right after submission — nothing is forced early);
  * a *materialized* entry is that dict sliced to one row and copied out
    (leading axis kept at 1 so a cached row quacks exactly like a one-row
    batch; the copy lets the producing dispatch's pinned output go).

Entries materialize lazily on first hit — the producing batch has almost
always been consumed by then (any handle read forces it), so materialization
is a few row copies, after which the batch reference is dropped and the
entry is compact. Eviction is LRU under a configurable ``capacity`` bound,
with one carve-out: a pending entry whose producing dispatch is still in
flight is pinned (evicting it would lose the row or force the dispatch
early), so the store may transiently overshoot ``capacity`` until those
batches are consumed.

Hit/miss/bypass accounting lives twice on purpose: per backend in
``BackendStats`` (``n_cache_hits``/``n_cache_misses``/``n_cache_bypass``)
and aggregated here across every backend sharing the store — the service's
fleet-level hit rate.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.phase_sim_torch import ENCODED_FIELDS

# EncodedDesign leaves that fill a device row (ENCODED_FIELDS plus the noc_pj
# scalar fill_row writes separately). Every leaf is a host numpy array of the
# same dtype and shape as in the JAX package, so the digests are
# byte-identical across the two packages.
_FIELDS: Tuple[str, ...] = tuple(ENCODED_FIELDS) + ("noc_pj",)


@dataclasses.dataclass
class StoreStats:
    """Fleet-level cache accounting (across every backend sharing the store).

    ``hits`` counts both store hits (served from a memoized row of an
    earlier dispatch) and same-dispatch aliases (two sessions submitting the
    identical candidate in one scheduler tick share one device row);
    ``misses`` counts rows actually dispatched and registered; ``bypasses``
    counts candidates that skipped the cache entirely (scalar-fallback
    pricing has no device row to memoize). ``evictions`` counts LRU drops."""

    hits: int = 0
    misses: int = 0
    bypasses: int = 0
    evictions: int = 0

    def hit_rate(self) -> float:
        """Hits over cacheable lookups (bypasses excluded)."""
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class _Entry:
    """One cached evaluation: pending ``(batch, j)`` until first hit, then a
    compact one-row column dict."""

    __slots__ = ("batch", "j", "row")

    def __init__(self, batch, j: int) -> None:
        self.batch = batch
        self.j = j
        self.row: Optional[Dict[str, np.ndarray]] = None

    def materialize(self) -> Dict[str, np.ndarray]:
        if self.row is None:
            host = self.batch.host()
            j = self.j
            # keep the leading axis at length 1: a cached row is shaped like
            # a one-row batch, so the backend's handle machinery reads it
            # through the exact same code path as a fresh dispatch. The rows
            # are copied (a one-row slice is already contiguous, so
            # ascontiguousarray would keep a view): the columns are views of
            # the dispatch's pinned output, which the entry must not hold.
            self.row = {k: np.array(v[j:j + 1]) for k, v in host.items()}
            self.batch = None  # drop the producing batch; entry is compact
        return self.row


class DesignStore:
    """LRU content-addressed map: evaluation digest → memoized device row.

    One store may back any number of backends/workloads concurrently — the
    workload digest is part of every key, so entries never collide across
    task graphs. Thread-unsafe by design (the service is a single-threaded
    tick loop)."""

    def __init__(self, capacity: int = 1 << 16) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.stats = StoreStats()
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    # ---- digests ---------------------------------------------------------
    @staticmethod
    def workload_digest(enc) -> bytes:
        """Content digest of an ``EncodedWorkload``: the static per-task
        arrays plus the task/workload name order (names pin the row layout
        the finish/bneck columns are decoded through). It reads the
        workload's host numpy leaves, never the device copy ``enc.on()``
        makes."""
        h = hashlib.sha256(b"workload")
        for name in ("work_ops", "read_bytes", "write_bytes", "burst", "llp",
                     "parent_mask", "wl_id"):
            arr = np.asarray(getattr(enc, name))
            h.update(name.encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        h.update("\x00".join(enc.names).encode())
        h.update("\x00".join(enc.wl_names).encode())
        return h.digest()

    @staticmethod
    def budget_digest(budget, alpha: float) -> bytes:
        """Digest of the Eq.-7 scoring inputs a dispatch row carries
        (``fill_budget``): per-workload latency budgets, power/area rails,
        and the dampening alpha. ``None`` (neutral scoring) is its own key."""
        h = hashlib.sha256(b"budget")
        if budget is None:
            h.update(b"none")
        else:
            for w in sorted(budget.latency_s):
                h.update(w.encode())
                h.update(np.float64(budget.latency_s[w]).tobytes())
            h.update(np.float64(budget.power_w).tobytes())
            h.update(np.float64(budget.area_mm2).tobytes())
        h.update(np.float64(alpha).tobytes())
        return h.digest()

    @staticmethod
    def key_of(ed, wl_digest: bytes, budget_digest: bytes) -> bytes:
        """The content address of one evaluation: every EncodedDesign leaf
        the device row is filled from. Block *names* (the slot dicts) are
        deliberately excluded — two designs that differ only in naming
        price identically, and name resolution happens at decode time
        against the consumer's own design."""
        h = hashlib.sha256(wl_digest)
        h.update(budget_digest)
        for f in _FIELDS:
            arr = np.asarray(getattr(ed, f))
            h.update(f.encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        return h.digest()

    # ---- cache operations ------------------------------------------------
    def lookup(self, key: bytes) -> Optional[Dict[str, np.ndarray]]:
        """The memoized one-row column dict for ``key``, or None. A hit
        refreshes LRU recency and is counted; misses are only counted when
        the backend registers the dispatched row (``insert``)."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        row = entry.materialize()
        self._evict()  # entries pinned at insert time may be evictable now
        return row

    def insert(self, key: bytes, batch, j: int) -> None:
        """Register row ``j`` of a just-submitted dispatch under ``key``
        (counted as the miss that produced it). Nothing is forced: the entry
        stays pending until its first hit materializes it."""
        self.stats.misses += 1
        self._entries[key] = _Entry(batch, j)
        self._entries.move_to_end(key)
        self._evict()

    def _evict(self) -> None:
        """LRU eviction down to ``capacity`` — but a pending entry whose
        producing batch is still in flight is PINNED: evicting it here would
        either silently lose the row (the hazard this fixes) or force the
        just-submitted non-blocking dispatch early (destroying the pipeline
        the backend exists for). Pinned entries let the store overshoot
        capacity transiently; the overshoot drains on the next ``insert`` or
        materializing ``lookup`` after the batch is consumed, since a
        consumed batch's entries evict normally."""
        excess = len(self._entries) - self.capacity
        if excess <= 0:
            return
        for key, entry in list(self._entries.items()):  # LRU → MRU
            if entry.row is None and not getattr(entry.batch, "consumed", True):
                continue  # pinned: source dispatch still in flight
            del self._entries[key]
            self.stats.evictions += 1
            excess -= 1
            if excess <= 0:
                return

    def note_alias_hit(self) -> None:
        """Count a same-dispatch alias: a duplicate candidate inside one
        batch shares the first occurrence's device row (no store entry is
        involved, but it is a dedupe all the same)."""
        self.stats.hits += 1

    def note_bypass(self) -> None:
        self.stats.bypasses += 1
