"""Collective accounting: the torch counterpart of ``repro.roofline.hlo``.

The reference parses the compiled HLO text and sums the result-shape bytes
of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute instruction. The port has no HLO: it reads the ops that
a step dispatches. :class:`StepCounter` is a ``TorchDispatchMode`` that
sees every op on a local (plain) tensor and files each ``_c10d_functional``
(or legacy ``c10d_functional``) collective under the reference's category,
with the bytes of its result on this device, the reference's convention:

  ``all_gather_into_tensor``                → all-gather
  ``all_reduce``                            → all-reduce
  ``reduce_scatter_tensor``                 → reduce-scatter
  ``all_to_all_single``                     → all-to-all
  ``_dtensor::shard_dim_alltoall``          → all-to-all (DTensor's shard-to-shard move)
  ``isend`` / ``irecv`` / ``batch_p2p_ops`` → collective-permute (the bytes sent or received)

(each with its ``_coalesced`` form, one op; on a mesh of device type
``"cpu"`` DTensor moves a shard to another dim by an all-gather and a local
chunk instead, as gloo has no all-to-all). ``wait_tensor`` is not counted,
as the reference skips ``*-done``; on meta tensors it is not dispatched at
all.

The mode returns ``NotImplemented`` when a ``DTensor`` is among an op's
types, as ``torch.distributed.tensor.debug.CommDebugMode`` does: DTensor
then runs the op with the mode still on the stack, and the mode sees its
local ops and the collectives of every redistribution, the implicit ones
inside an op's dispatch (a matmul operand gathered) included. A mode that
ran a DTensor op itself would see only the collectives issued from Python.
The ops that DTensor's sharding propagation runs on fake tensors of the
global shapes, to learn an output's shape, touch no device and are skipped.

Beside the collectives, the same mode counts per device, on local tensors
only:

  * ``flops``: of the products, by ``torch.utils.flop_counter``'s formulas;
  * ``bytes accessed``: the operands read plus the results written, op by
    op, with no fusion (views move nothing). This is larger than XLA's
    fused count and is never compared with it;
  * live bytes: a storage counts from the op that first returns it until it
    is freed (``weakref.finalize`` on the storage, which its views share);
    ``peak_bytes`` is the most ever live, over what was live at the start
    (:meth:`StepCounter.hold` registers the arguments);
  * flash kernel calls: the flash wrapper's ``ops.calls()`` (launches on
    the card, meta-path calls in a dry run), read at entry and exit. A
    ctypes kernel is invisible to a dispatch mode, as a Pallas custom
    call's flops are to XLA's cost analysis.

Each collective is also filed under its issuer (:func:`collective_bytes_by_op`):
the op that sent it, which is the DTensor op being dispatched (the last
one the mode saw), ``redistribute`` for an explicit redistribution,
``redistribute.backward`` for its gradient's, or the functional collective
itself where port code calls it; and where in the port it was sent from:
the innermost two frames of ``repro_torch`` on the Python stack or, in a
backward that runs no port code, the autograd node being run.

Every op is filed under the part of the step it belongs to: the ops that
run inside an autograd graph task (the backward, activation-checkpoint
recomputes included) are a backward; the runs between are forwards, and
the run after the last backward is the optimizer update. Labels live in the
mode's own state, not in a ``ContextVar``: the backward may run on
autograd's device thread, where the mode travels with autograd's
thread-local state and a context variable does not.
"""
from __future__ import annotations

import os
import sys
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, is_traceable_wrapper_subclass
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels.flash_attention import ops as flash_ops

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # src/repro_torch
_REDISTRIBUTE = {"Redistribute.forward": "redistribute", "NestedRedistribute.forward": "redistribute.backward"}


def collective_kind(func) -> Optional[str]:
    """The reference's category of a dispatched op, or None for an op that
    is no counted collective."""
    ns, _, name = func.name().partition("::")
    return _KIND.get(name.split(".")[0]) if ns in _NAMESPACES else None


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _empty() -> Dict[str, int]:
    """One part's sums: the bytes (under each category's name) and ops
    (``n:<category>``, and ``count`` for all) of its collectives, its flops
    and bytes accessed."""
    out = {c: 0 for c in COLLECTIVES}
    out.update({f"n:{c}": 0 for c in COLLECTIVES})
    out.update(count=0, flops=0, bytes_accessed=0)
    return out


class StepCounter(TorchDispatchMode):
    """Counts what a step dispatches on local tensors (module docstring).
    Use as a context manager around one step; read :func:`collective_bytes`,
    :func:`collective_counts`, :func:`collective_bytes_per_computation`,
    :meth:`totals` (``flops``, ``bytes_accessed``), ``peak_bytes``,
    ``flash_calls`` and ``ops`` (each collective op's name and calls)
    after it."""

    def __init__(self):
        super().__init__()
        self._segments: List[Tuple[bool, Dict[str, int]]] = []  # (in a backward, sums)
        self._lock = threading.Lock()  # finalizers may run on autograd's device thread
        self._live_keys: set = set()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.flash_calls = 0
        self._flash0 = 0
        self.ops: Dict[str, int] = {}
        self.by_op: Dict[str, Dict[str, int]] = {}
        self._last_op = "?"  # the DTensor op dispatched last: the issuer of its implicit collectives

    # ---- storages ------------------------------------------------------------
    def _storage(self, t: torch.Tensor, count: bool, own: bool = False) -> None:
        """Register ``t``'s storage as live (its bytes counted where
        ``count``; ``own``: only ``t``'s own bytes, for a collective's result,
        whose meta kernel may return a view into a buffer of the whole group's
        size, as ``_dtensor::shard_dim_alltoall``'s does, where the card's
        returns a tensor of the result's size)."""
        if is_traceable_wrapper_subclass(t):
            return
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._live_keys:
                return
            self._live_keys.add(key)
            n = (min(_nbytes(t), st.nbytes()) if own else st.nbytes()) if count else 0
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        with self._lock:
            self._live_keys.discard(key)
            self.live_bytes -= n

    def hold(self, *trees) -> None:
        """Register the storages of the tensors (DTensors: their local
        shards) in ``trees`` as live before the step, counting no bytes for
        them: ``peak_bytes`` is then the most live beyond them."""
        for t in _tensors(trees):
            self._storage(getattr(t, "_local_tensor", t), count=False)

    # ---- the mode ------------------------------------------------------------
    def __enter__(self):
        self._flash0 = flash_ops.calls()
        return super().__enter__()

    def __exit__(self, *exc):
        self.flash_calls += flash_ops.calls() - self._flash0
        return super().__exit__(*exc)

    def _part(self) -> Dict[str, int]:
        in_bwd = torch._C._current_graph_task_id() != -1
        with self._lock:
            if not self._segments or self._segments[-1][0] != in_bwd:
                self._segments.append((in_bwd, _empty()))
            return self._segments[-1][1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self._last_op = str(func)
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's sharding propagation, on fake tensors of global shapes: no device work
        sums = self._part()
        kind = collective_kind(func)
        if kind is not None:
            moved = _tensors(args) if kind == "collective-permute" else _tensors(out)
            nbytes = sum(_nbytes(t) for t in moved)
            sums[kind] += nbytes
            sums[f"n:{kind}"] += 1
            sums["count"] += 1
            issuer = self._issuer(func)
            with self._lock:
                self.ops[func.name()] = self.ops.get(func.name(), 0) + 1
                row = self.by_op.setdefault(issuer, _by_op_row())
                row[kind] += nbytes
                row["bytes"] += nbytes
                row["count"] += 1
        fl = flop_registry.get(func._overloadpacket)
        if fl is not None:
            sums["flops"] += int(fl(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not func.is_view:
            sums["bytes_accessed"] += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._storage(t, count=True, own=kind is not None)
        return out

    def _issuer(self, func) -> str:
        """``"<op> @ <where>"`` for a collective being dispatched now (module
        docstring). An explicit redistribution's forward leaves its ``where``
        on its autograd node, for the collective of its backward."""
        op, where, node_ctx = None, [], None
        frame = sys._getframe(2)
        while frame is not None and len(where) < 2:
            code, module = frame.f_code, frame.f_globals.get("__name__", "")
            if module == "torch.autograd.graph" and code.co_name == "_engine_run_backward":
                break  # outside the backward: the caller of autograd, not the issuer
            if op is None and module == "torch.distributed.tensor._redistribute":
                op = _REDISTRIBUTE.get(code.co_qualname)
                node_ctx = frame.f_locals.get("ctx") if op == "redistribute" else None
            elif op is None and module == "torch.distributed.tensor._dispatch":
                op = self._last_op
            if code.co_filename.startswith(_PORT) and not code.co_filename.endswith("hlo.py"):
                where.append(f"{os.path.relpath(code.co_filename, _PORT)}:{code.co_name}")
            frame = frame.f_back
        if op is None:  # a functional collective called directly
            op = func.name()
        where_s = " < ".join(where)
        if where and node_ctx is not None and hasattr(node_ctx, "metadata"):
            node_ctx.metadata["issuer_where"] = where_s
        if not where:
            node = torch._C._current_autograd_node()
            where_s = "?" if node is None else node.metadata.get(
                "issuer_where", f"backward {node.name()}")
        return f"{op} @ {where_s}"

    # ---- reading -------------------------------------------------------------
    def parts(self) -> Dict[str, Dict[str, int]]:
        """The sums of each part of the step, in order: ``forward.i`` and
        ``backward.i`` for microbatch i, and ``update`` (what runs after the
        last backward)."""
        with self._lock:
            segments = list(self._segments)
        last_bwd = max((i for i, (b, _) in enumerate(segments) if b), default=-1)
        out: Dict[str, Dict[str, int]] = {}
        n_fwd = n_bwd = 0
        for i, (in_bwd, sums) in enumerate(segments):
            if in_bwd:
                name, n_bwd = f"backward.{n_bwd}", n_bwd + 1
            elif 0 <= last_bwd < i:
                name = "update"
            else:
                name, n_fwd = f"forward.{n_fwd}", n_fwd + 1
            out[name] = dict(sums)
        return out

    def totals(self) -> Dict[str, int]:
        """The sums of the whole step (the keys of one part's)."""
        out = _empty()
        for sums in self.parts().values():
            for k, v in sums.items():
                out[k] += v
        return out


def _by_op_row() -> Dict[str, int]:
    out = {c: 0 for c in COLLECTIVES}
    out.update(bytes=0, count=0)
    return out


def collective_bytes_by_op(counter: StepCounter) -> Dict[str, Dict[str, int]]:
    """Each issuer's collectives (:meth:`StepCounter._issuer`): its bytes by
    category, ``bytes`` in all and ``count`` (ops), the most bytes first.
    Over every issuer the bytes sum to :func:`collective_bytes`'s, category
    by category."""
    with counter._lock:
        rows = sorted(counter.by_op.items(), key=lambda kv: -kv[1]["bytes"])
    return {k: dict(v) for k, v in rows}


def _collectives(sums: Dict[str, int]) -> Dict[str, int]:
    out = {c: sums[c] for c in COLLECTIVES}
    out["count"] = sums["count"]
    out["total"] = sum(out[c] for c in COLLECTIVES)
    return out


def collective_bytes(counter: StepCounter) -> Dict[str, int]:
    """Result bytes a device per collective category over the whole step,
    with ``count`` (collective ops) and ``total`` (bytes): the reference's
    dict."""
    return _collectives(counter.totals())


def collective_counts(counter: StepCounter) -> Dict[str, int]:
    """Collective ops a device per category over the whole step."""
    totals = counter.totals()
    return {c: totals[f"n:{c}"] for c in COLLECTIVES}


def collective_bytes_per_computation(counter: StepCounter) -> Dict[str, Dict[str, int]]:
    """The same sums grouped by the step's parts (:meth:`StepCounter.parts`).
    The reference groups by HLO computation so that a caller can apply
    while-loop trip counts to loop bodies; the port loops over layers and
    microbatches in Python, so each part already holds every trip."""
    return {name: _collectives(sums) for name, sums in counter.parts().items()}
