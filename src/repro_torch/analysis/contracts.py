"""Cross-file layout contracts of the port: invariants that live in two (or
more) files at once and desync silently.

Each :class:`Contract` names the files that must move together, binds the
*real* objects from every side (import, Python AST, or a read of the CUDA
source — never a copy of the expected value), and diffs them. A finding
always names every file involved, because the fix is "edit these
together", not "this line is wrong".

The check logic itself is in pure functions (``check_*``) that take plain
values, so the tests can feed them deliberately desynced inputs without
monkeypatching modules; the contract wrappers only *bind* real values and
translate messages into :class:`~repro_torch.analysis.findings.Finding`
records. Every contract takes the repo root it reads (default: this
checkout), so a test can run it on a mutated copy of the tree.

Registered contracts:

``scal-cols``      ``core/scal_layout.py`` is the single source of truth for
                   the packed scalar-column layout; ``ops.py``'s unpack,
                   the backend's host unpack, ``kernel.out_layout``'s tail
                   offsets, and the CUDA source — its ``N_SCAL``, its
                   positional ``out[i] = …`` rollup and its ``o_pe … o_bn``
                   tail offsets — must all agree with it. The CUDA side is
                   written by hand: nothing but this contract ties it to the
                   Python side.
``chain-carry``    :class:`~repro_torch.core.device_explore.ChainCarry`
                   leaf order vs the :class:`MoveTable` row count, the
                   per-class capacity widths ``fresh_carry`` materializes
                   and the module's ``_STATE`` swap-on-accept leaves (the
                   taboo-width aliasing class).
``move-codes``     the ``MV_*`` code enumeration vs ``_KIND_PRECEDENCE``
                   and the chain step's ``valid =`` dispatch expression —
                   a new move kind must appear in all three.
``policy-registry`` ``POLICIES`` vs per-class ``device_menu`` eligibility
                   vs ``MENUS`` vs both tables in ``docs/HEURISTICS.md``.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib
import os
import re
import sys
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = [
    "Contract",
    "CONTRACTS",
    "REPO",
    "SourceShapeError",
    "run_contracts",
    "check_scal_cols",
    "check_rollup_anchors",
    "check_tail_chain",
    "check_chain_carry",
    "check_move_codes",
    "check_policy_registry",
    "parse_md_tables",
    "cuda_n_scal",
    "cuda_rollup_sources",
    "cuda_tail_chain",
    "layout_chain",
    "tail_slice_starts",
    "cat_order",
    "dispatch_mv_names",
    "state_tuple_fields",
]

# analysis/ → repro_torch/ → src/ → the checkout
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

F_LAYOUT = "src/repro_torch/core/scal_layout.py"
F_KERNEL = "src/repro_torch/kernels/phase_sim/kernel.py"
F_OPS = "src/repro_torch/kernels/phase_sim/ops.py"
F_BACKEND = "src/repro_torch/core/backend.py"
F_CUDA = "src/repro_torch/kernels/phase_sim/csrc/phase_sim.cu"
F_DEVEXP = "src/repro_torch/core/device_explore.py"
F_POLICY = "src/repro_torch/core/policy.py"
F_HEUR = "docs/HEURISTICS.md"


class SourceShapeError(ValueError):
    """A contract's subject no longer has the shape its extractor reads: the
    contract lost its anchor, which is a finding, never a silent pass."""


@dataclasses.dataclass(frozen=True)
class Contract:
    """One cross-file invariant. ``check(root)`` returns findings (empty =
    holds) for the tree at ``root``."""

    name: str
    description: str
    files: Tuple[str, ...]
    check: Callable[[str], List[Finding]]

    def run(self, root: Optional[str] = None) -> List[Finding]:
        try:
            return self.check(root or REPO)
        except Exception as e:  # a contract that cannot even bind is a finding
            return [Finding(
                pass_name="contracts", rule=self.name,
                message=f"contract could not bind its subjects: {type(e).__name__}: {e}",
                path=self.files[0], related=self.files[1:],
            )]


def _src(root: str, rel: str) -> str:
    with open(os.path.join(root, rel), "r", encoding="utf-8") as fh:
        return fh.read()


def _is_port(name: str) -> bool:
    return name == "repro_torch" or name.startswith("repro_torch.")


@contextlib.contextmanager
def _port_at(root: str) -> Iterator[Callable[[str], object]]:
    """An importer of the port's modules as they are under ``root/src``.
    For this checkout that is the imported package; for another tree (a
    mutated copy) the package is imported afresh from there and the
    process's own ``repro_torch`` modules are put back afterwards."""
    if os.path.realpath(root) == os.path.realpath(REPO):
        yield importlib.import_module
        return
    src = os.path.join(os.path.abspath(root), "src")
    saved = {k: v for k, v in sys.modules.items() if _is_port(k)}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, src)
    importlib.invalidate_caches()
    try:
        yield importlib.import_module
    finally:
        sys.path.remove(src)
        for k in [k for k in sys.modules if _is_port(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


# ---------------------------------------------------------------------------
# pure checks (unit-testable with injected, deliberately-desynced values)
# ---------------------------------------------------------------------------
def check_scal_cols(
    layout_cols: Sequence[str],
    kernel_cols: Sequence[str],
    backend_prefix: Sequence[str],
    backend_n_fixed: int,
    rollup_width: Optional[int] = None,
) -> List[str]:
    out: List[str] = []
    if tuple(kernel_cols) != tuple(layout_cols):
        out.append(
            "ops.SCAL_COLS != scal_layout.SCAL_COLS: "
            f"{tuple(kernel_cols)!r} vs {tuple(layout_cols)!r}"
        )
    if tuple(layout_cols[: len(backend_prefix)]) != tuple(backend_prefix):
        out.append(
            "backend._SCAL_COLS is not a prefix of the layout: "
            f"{tuple(backend_prefix)!r} vs {tuple(layout_cols)!r}"
        )
    if backend_n_fixed != len(layout_cols):
        out.append(
            f"the packed row's tail starts at column {backend_n_fixed} "
            f"(out_layout's `pe`) but SCAL_COLS names {len(layout_cols)} "
            "— every telemetry column read after the fixed block shifts"
        )
    if rollup_width is not None and rollup_width != len(layout_cols):
        out.append(
            f"the kernel rollup writes {rollup_width} scalars but "
            f"SCAL_COLS names {len(layout_cols)} — the packed scal row "
            "and its schema disagree"
        )
    return out


# schema-name → source stem that must appear in the CUDA rollup's
# ``out[i] = <expr>;`` at the SAME index. The rollup is positional (stores
# of local values, no names), so name-diffing alone cannot catch a
# reordered schema — these anchors tie the column name to the expression
# that computes it. latency_s is deliberately unanchored (the kernel calls
# it `now`).
ROLLUP_ANCHORS = {
    "energy_j": "energy",
    "power_w": "power",
    "area_mm2": "area",
    "fitness": "fitness",
    "alp_time_s": "alp",
    "traffic_bytes": "tr",
    "n_phases": "nph",
    "all_done": "all_done",
    "kind_pe_s": "acc_kind[0]",
    "kind_mem_s": "acc_kind[1]",
    "kind_noc_s": "acc_kind[2]",
    "top_bneck_pe": "top_pe",
    "top_bneck_mem": "top_mem",
}


def check_rollup_anchors(
    layout_cols: Sequence[str],
    rollup_srcs: Optional[Sequence[str]],
    anchors: Optional[Dict[str, str]] = None,
) -> List[str]:
    """The kernel rollup element at each column's index must mention that
    column's anchor stem — catches a reorder of the (single-sourced)
    schema that the tautological name-diff cannot see."""
    anchors = ROLLUP_ANCHORS if anchors is None else anchors
    if rollup_srcs is None or len(rollup_srcs) != len(layout_cols):
        return []  # width mismatch is already its own finding
    out: List[str] = []
    for i, col in enumerate(layout_cols):
        stem = anchors.get(col)
        if stem is not None and stem not in rollup_srcs[i]:
            out.append(
                f"SCAL_COLS[{i}] = {col!r} but the kernel rollup element "
                f"there is `{rollup_srcs[i]}` (expected it to mention "
                f"{stem!r}) — the schema and the kernel's positional "
                "stores have desynced"
            )
    return out


# kernel.out_layout's tail segment → the output key it carries
TAIL_KEYS = {
    "pe": "pe_bneck_s",
    "mem": "mem_bneck_s",
    "noc": "noc_bneck_s",
    "wl": "wl_latency_s",
    "fin": "finish_s",
    "bn": "bneck_code",
}


def check_tail_chain(
    cuda_chain: Sequence[Tuple[str, str]],
    kernel_chain: Sequence[Tuple[str, str]],
    lay_keys: Dict[str, str],
    pack_order: Sequence[str],
    slice_starts: Dict[str, Dict[str, str]],
) -> List[str]:
    """The per-slot tail after the fixed scal block: the CUDA source's
    offset chain (``[(segment, increment)]``, the first increment the base)
    must equal ``kernel.out_layout``'s; the plain version's packing
    (``pack_order``: output keys in concatenation order) must follow it;
    and every reader's slices (``slice_starts[reader][key]`` = the
    ``out_layout`` key a slice starts at) must start each output at its
    own segment (``lay_keys`` maps ``out_layout``'s keys to segments)."""
    out: List[str] = []
    if list(cuda_chain) != list(kernel_chain):
        out.append(
            f"the CUDA tail offsets {list(cuda_chain)!r} != kernel.out_layout's "
            f"{list(kernel_chain)!r} — the kernel writes the tail where the "
            "host does not read it"
        )
    order = [TAIL_KEYS.get(seg, seg) for seg, _ in kernel_chain]
    packed = [k for k in pack_order if k in TAIL_KEYS.values()]
    if packed != order:
        out.append(
            f"ops.pack_plain concatenates the tail as {packed!r} but "
            f"out_layout orders it {order!r} — the plain version's rows and "
            "the kernel's disagree"
        )
    seg_of = {v: k for k, v in TAIL_KEYS.items()}
    for reader, starts in sorted(slice_starts.items()):
        for key, lay in sorted(starts.items()):
            if key in seg_of and lay_keys.get(lay) != seg_of[key]:
                out.append(
                    f"{reader} reads {key!r} from lay[{lay!r}] (segment "
                    f"{lay_keys.get(lay)!r}) but out_layout puts it at "
                    f"{seg_of.get(key)!r}"
                )
    return out


# the mapping-only carry prefix: checkpoints and parity tests iterate
# these leaves positionally, so their order is load-bearing
CARRY_PREFIX = (
    "task_pe", "task_mem", "fitness", "key", "taboo", "pe_bneck", "mem_bneck",
)


def check_chain_carry(
    field_names: Sequence[str],
    taboo_width: int,
    n_moves: int,
    pe_widths: Dict[str, int],
    cap_pe: int,
    mem_widths: Dict[str, int],
    cap_mem: int,
    state_fields: Optional[Sequence[str]] = None,
) -> List[str]:
    out: List[str] = []
    if tuple(field_names[: len(CARRY_PREFIX)]) != CARRY_PREFIX:
        out.append(
            "ChainCarry's first leaves are no longer the mapping-only prefix "
            f"{CARRY_PREFIX!r} (got {tuple(field_names[:7])!r}) — "
            "checkpoints and parity tests iterate leaves positionally"
        )
    if taboo_width != n_moves:
        out.append(
            f"fresh_carry taboo width ({taboo_width}) != MoveTable.n_moves "
            f"({n_moves}) — taboo TTLs silently alias across move rows "
            "(the taboo-width desync)"
        )
    for col, w in pe_widths.items():
        if w != cap_pe:
            out.append(
                f"carry.{col} width ({w}) != cap_pe ({cap_pe}) — the "
                "chain step writes by slot index into this column"
            )
    for col, w in mem_widths.items():
        if w != cap_mem:
            out.append(
                f"carry.{col} width ({w}) != cap_mem ({cap_mem})"
            )
    if state_fields is not None:
        state = tuple(state_fields)
        expect = tuple(
            f for f in field_names
            if f not in ("fitness", "key", "taboo", "pe_bneck", "mem_bneck")
        )
        if state != expect:
            missing = [f for f in expect if f not in state]
            extra = [f for f in state if f not in expect]
            out.append(
                "_STATE does not cover the carry's swap-on-accept leaves "
                f"(missing {missing!r}, extra {extra!r}) — an uncovered "
                "leaf keeps its rejected value after an accept"
            )
    return out


def check_move_codes(
    codes: Dict[str, int],
    precedence_len: int,
    dispatch_names: Sequence[str],
) -> List[str]:
    out: List[str] = []
    vals = sorted(codes.values())
    if vals != list(range(len(codes))):
        out.append(
            f"MV_* codes are not a dense 0..{len(codes) - 1} enumeration: "
            f"{dict(sorted(codes.items(), key=lambda kv: kv[1]))!r} — the "
            "kind column indexes _KIND_PRECEDENCE positionally"
        )
    for name, v in codes.items():
        want_suffix = "_PE" if v % 2 == 0 else "_MEM"
        if not name.endswith(want_suffix):
            out.append(
                f"{name}={v} breaks the even=PE / odd=MEM convention the "
                "validity mask and the move's class writes rely on"
            )
    if precedence_len != len(codes):
        out.append(
            f"_KIND_PRECEDENCE has {precedence_len} entries for "
            f"{len(codes)} MV_* codes — the farsi menu would read a "
            "precedence off the end (or miss a kind)"
        )
    missing = sorted(set(codes) - set(dispatch_names))
    if missing:
        out.append(
            f"the chain step's `valid =` dispatch never tests {missing!r}"
            " — rows of that kind are unconditionally invalid (dead moves)"
        )
    return out


def check_policy_registry(
    policy_menus: Dict[str, str],
    menus: Sequence[str],
    doc_menu_rows: Dict[str, str],
    doc_listed_policies: Sequence[str],
) -> List[str]:
    out: List[str] = []
    for name, menu in sorted(policy_menus.items()):
        if menu not in menus:
            out.append(
                f"POLICIES[{name!r}].device_menu = {menu!r} is not in "
                f"device_explore.MENUS {tuple(menus)!r}"
            )
        doc = doc_menu_rows.get(name)
        if doc is None:
            out.append(
                f"policy {name!r} is missing from the device-eligibility "
                "table in docs/HEURISTICS.md"
            )
        elif doc != menu:
            out.append(
                f"docs/HEURISTICS.md says {name!r} uses menu {doc!r} but "
                f"the class declares device_menu={menu!r}"
            )
    listed = set(doc_listed_policies)
    for name in sorted(policy_menus):
        if name not in listed:
            out.append(
                f"policy {name!r} is registered but absent from the "
                "'Registered policies' table in docs/HEURISTICS.md"
            )
    for name in sorted(listed - set(policy_menus)):
        out.append(
            f"docs/HEURISTICS.md lists policy {name!r} which is not in "
            "POLICIES"
        )
    for name in sorted(set(doc_menu_rows) - set(policy_menus)):
        out.append(
            f"device-eligibility table names unknown policy {name!r}"
        )
    return out


# ---------------------------------------------------------------------------
# markdown table parsing (docs/HEURISTICS.md is a contract subject)
# ---------------------------------------------------------------------------
def parse_md_tables(text: str) -> List[List[List[str]]]:
    """All pipe-tables in a markdown document as lists of rows of cell
    strings (header row included, separator rows dropped)."""
    tables: List[List[List[str]]] = []
    cur: List[List[str]] = []
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("|") and s.endswith("|"):
            cells = [c.strip() for c in s[1:-1].split("|")]
            if all(re.fullmatch(r":?-{3,}:?", c) for c in cells):
                continue
            cur.append(cells)
        else:
            if cur:
                tables.append(cur)
                cur = []
    if cur:
        tables.append(cur)
    return tables


def _ticked(cell: str) -> List[str]:
    return re.findall(r"`([^`]+)`", cell)


def _heuristics_doc_bindings(text: str) -> Tuple[Dict[str, str], List[str]]:
    """(policy → documented menu) from the device-eligibility table, and
    the policy names listed in the registered-policies table."""
    menu_rows: Dict[str, str] = {}
    listed: List[str] = []
    for table in parse_md_tables(text):
        header = [c.lower() for c in table[0]]
        if header[:2] == ["name", "selection"]:
            for row in table[1:]:
                listed.extend(_ticked(row[0]))
        elif header[0] == "policy" and "device_menu" in header[1]:
            for row in table[1:]:
                menus = _ticked(row[1])
                menu = menus[0] if menus else ""
                for name in _ticked(row[0]):
                    menu_rows[name] = menu
    return menu_rows, listed


# ---------------------------------------------------------------------------
# CUDA source extraction: regular expressions over the comment-stripped
# source, each raising SourceShapeError where the source left the shape read
# ---------------------------------------------------------------------------
def _code(src: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)


def _squash(expr: str) -> str:
    return " ".join(expr.split())


def cuda_n_scal(src: str) -> int:
    """The value of the source's one ``constexpr int N_SCAL = <n>;``."""
    hits = re.findall(r"\bconstexpr\s+int\s+N_SCAL\s*=\s*(\d+)\s*;", _code(src))
    if len(hits) != 1:
        raise SourceShapeError(
            f"expected one `constexpr int N_SCAL = <n>;`, found {len(hits)}")
    return int(hits[0])


def cuda_rollup_sources(src: str) -> List[str]:
    """The expression of each ``out[<i>] = <expr>;`` store with a literal
    index — the packed scal row, in index order. The indices must run
    contiguously from 0, each stored once."""
    hits = re.findall(r"\bout\[\s*(\d+)\s*\]\s*=\s*([^;]+);", _code(src))
    if not hits:
        raise SourceShapeError("no `out[<i>] = <expr>;` rollup stores")
    by_idx: Dict[int, str] = {}
    for idx, expr in hits:
        if int(idx) in by_idx:
            raise SourceShapeError(f"rollup column {idx} is stored twice")
        by_idx[int(idx)] = _squash(expr)
    if sorted(by_idx) != list(range(len(by_idx))):
        raise SourceShapeError(
            f"rollup indices {sorted(by_idx)} do not run contiguously from 0")
    return [by_idx[i] for i in range(len(by_idx))]


# the CUDA source's names for out_layout's increments
_CUDA_WIDTHS = {
    "p.S_pe": "s_pe", "p.S_mem": "s_mem", "N": "n_noc", "p.N": "n_noc",
    "p.NW": "n_wl", "T": "t", "p.T": "t",
}


def cuda_tail_chain(src: str) -> List[Tuple[str, str]]:
    """The ``const int o_<seg> = …;`` offset chain of the packed row's tail
    as ``[(seg, increment)]``: the first defined as ``N_SCAL``, each next
    as the previous offset plus a width (named as ``out_layout`` names it)."""
    hits = re.findall(r"\bconst\s+int\s+o_(\w+)\s*=\s*([^;]+);", _code(src))
    if not hits:
        raise SourceShapeError("no `const int o_<segment> = …;` tail offsets")
    chain: List[Tuple[str, str]] = []
    for seg, expr in hits:
        expr = _squash(expr)
        if not chain:
            if expr != "N_SCAL":
                raise SourceShapeError(
                    f"the tail's first offset o_{seg} = `{expr}`, not N_SCAL")
            chain.append((seg, "N_SCAL"))
            continue
        prev = chain[-1][0]
        m = re.fullmatch(rf"o_{prev}\s*\+\s*(.+)", expr)
        if m is None:
            raise SourceShapeError(
                f"o_{seg} = `{expr}` does not extend the chain from o_{prev}")
        chain.append((seg, _CUDA_WIDTHS.get(m.group(1), m.group(1))))
    return chain


# ---------------------------------------------------------------------------
# Python AST extraction (the side of a contract that is *code shape*)
# ---------------------------------------------------------------------------
def _find_func(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _func(src: str, name: str) -> ast.FunctionDef:
    fn = _find_func(ast.parse(src), name)
    if fn is None:
        raise SourceShapeError(f"no function `{name}`")
    return fn


def layout_chain(src: str) -> Tuple[List[Tuple[str, str]], Dict[str, str]]:
    """``kernel.out_layout``'s offset chain as ``[(seg, increment)]`` (the
    first increment ``N_SCAL``), and its returned dict's keys → segment."""
    fn = _func(src, "out_layout")
    chain: List[Tuple[str, str]] = []
    keys: Dict[str, str] = {}
    for stmt in fn.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            seg, v = stmt.targets[0].id, stmt.value
            if not chain:
                if not (isinstance(v, ast.Name) and v.id == "N_SCAL"):
                    raise SourceShapeError(
                        f"out_layout's first offset {seg} = `{ast.unparse(v)}`, not N_SCAL")
                chain.append((seg, "N_SCAL"))
            elif (isinstance(v, ast.BinOp) and isinstance(v.op, ast.Add)
                  and isinstance(v.left, ast.Name) and v.left.id == chain[-1][0]):
                chain.append((seg, ast.unparse(v.right)))
            else:
                raise SourceShapeError(
                    f"out_layout's {seg} = `{ast.unparse(v)}` does not extend its chain")
        elif isinstance(stmt, ast.Return) and isinstance(stmt.value, ast.Dict):
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Name):
                    keys[k.value] = v.id
    if not chain or not keys:
        raise SourceShapeError("out_layout lost its offset chain or its returned keys")
    return chain, keys


def _lay_key(node: ast.AST) -> Optional[str]:
    """``X`` of a ``lay["X"]`` expression."""
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
            and node.value.id == "lay" and isinstance(node.slice, ast.Constant)):
        return node.slice.value
    return None


def _slice_start(expr: ast.AST) -> Optional[str]:
    """The ``lay`` key of the first ``rows[:, lay["X"]:…]`` slice in
    ``expr``."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Subscript):
            continue
        sl = node.slice
        for p in sl.elts if isinstance(sl, ast.Tuple) else [sl]:
            if isinstance(p, ast.Slice) and p.lower is not None:
                key = _lay_key(p.lower)
                if key is not None:
                    return key
    return None


def tail_slice_starts(src: str, func: str) -> Dict[str, str]:
    """Output key → the ``lay`` key its slice starts at, for every
    ``"key": x[:, lay["X"]:…]`` dict entry and ``d["key"] = x[:, lay["X"]:…]``
    store in the functions named ``func``."""
    fns = [n for n in ast.walk(ast.parse(src))
           if isinstance(n, ast.FunctionDef) and n.name == func]
    out: Dict[str, str] = {}
    for node in (sub for fn in fns for sub in ast.walk(fn)):
        pairs = []
        if isinstance(node, ast.Dict):
            pairs = list(zip(node.keys, node.values))
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Subscript):
            pairs = [(node.targets[0].slice, node.value)]
        for k, v in pairs:
            start = _slice_start(v)
            if isinstance(k, ast.Constant) and isinstance(k.value, str) and start:
                out[k.value] = start
    if not out:
        raise SourceShapeError(f"`{func}` slices nothing off the packed row's tail")
    return out


def cat_order(src: str, func: str, holder: str = "out") -> List[str]:
    """The ``holder["key"]`` names, in order, of the list ``func`` hands to
    ``torch.cat``."""
    fn = _func(src, func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "cat" and node.args
                and isinstance(node.args[0], (ast.List, ast.Tuple))):
            keys = []
            for el in node.args[0].elts:
                for sub in ast.walk(el):
                    if (isinstance(sub, ast.Subscript) and isinstance(sub.value, ast.Name)
                            and sub.value.id == holder and isinstance(sub.slice, ast.Constant)):
                        keys.append(sub.slice.value)
                        break
            return keys
    raise SourceShapeError(f"`{func}` no longer concatenates its outputs with torch.cat")


def dispatch_mv_names(src: str) -> Optional[List[str]]:
    """Every ``MV_*`` name referenced in the ``valid = …`` expression of the
    chain step (``_ChainBlock._step``); None where the step or its
    ``valid =`` is gone."""
    fn = _find_func(ast.parse(src), "_step")
    if fn is None:
        return None
    names: List[str] = []
    found = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "valid" for t in node.targets
        ):
            found = True
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name) and sub.id.startswith("MV_"):
                    names.append(sub.id)
    return sorted(set(names)) if found else None


def state_tuple_fields(src: str) -> Optional[List[str]]:
    """The module-level ``_STATE`` tuple literal — the carry leaves the
    accept step swaps wholesale."""
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "_STATE" for t in node.targets
        ):
            if isinstance(node.value, (ast.Tuple, ast.List)):
                return [
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                ]
    return None


# ---------------------------------------------------------------------------
# contract bindings (real imports / real fixtures)
# ---------------------------------------------------------------------------
def _msgs_to_findings(
    msgs: List[str], rule: str, path: str, related: Tuple[str, ...]
) -> List[Finding]:
    return [
        Finding(pass_name="contracts", rule=rule, message=m,
                path=path, related=related)
        for m in msgs
    ]


def _anchored(msgs: List[str], what: str, fn: Callable[[], object]):
    """``fn()``, or None with a "lost its anchor" message in ``msgs``."""
    try:
        return fn()
    except (SourceShapeError, SyntaxError) as e:
        msgs.append(f"{what}: the contract lost its anchor ({e})")
        return None


def _check_scal(root: str) -> List[Finding]:
    msgs: List[str] = []
    cu, kern, ops_src, back_src = (
        _src(root, f) for f in (F_CUDA, F_KERNEL, F_OPS, F_BACKEND))
    with _port_at(root) as imp:
        scal_layout = imp("repro_torch.core.scal_layout")
        backend = imp("repro_torch.core.backend")
        kernel = imp("repro_torch.kernels.phase_sim.kernel")
        ops = imp("repro_torch.kernels.phase_sim.ops")
        cols = tuple(scal_layout.SCAL_COLS)
        rollup = _anchored(msgs, F_CUDA, lambda: cuda_rollup_sources(cu))
        msgs.extend(check_scal_cols(
            layout_cols=cols,
            kernel_cols=ops.SCAL_COLS,
            backend_prefix=backend._SCAL_COLS,
            backend_n_fixed=kernel.out_layout(1, 1, 1, 1, 1)["pe"],
            rollup_width=None if rollup is None else len(rollup),
        ))
        n_cu = _anchored(msgs, F_CUDA, lambda: cuda_n_scal(cu))
        if n_cu is not None and n_cu != len(cols):
            msgs.append(
                f"phase_sim.cu declares N_SCAL = {n_cu} but SCAL_COLS names "
                f"{len(cols)} — the kernel's tail offsets start in the wrong column")
        msgs.extend(check_rollup_anchors(cols, rollup))
        # the index constants must keep addressing what their names claim
        if cols[scal_layout.KIND_START:scal_layout.KIND_STOP] \
                != scal_layout.BNECK_KIND_COLS:
            msgs.append("KIND_START/KIND_STOP no longer bracket the "
                        "bneck-kind triple")
        if (cols[scal_layout.TOP_PE_COL], cols[scal_layout.TOP_MEM_COL]) \
                != scal_layout.TOP_BNECK_COLS:
            msgs.append("TOP_PE_COL/TOP_MEM_COL do not address the "
                        "top-bottleneck pair")
    cu_chain = _anchored(msgs, F_CUDA, lambda: cuda_tail_chain(cu))
    chain = _anchored(msgs, F_KERNEL, lambda: layout_chain(kern))
    pack = _anchored(msgs, F_OPS, lambda: cat_order(ops_src, "pack_plain"))
    starts = {
        "ops.unpack": _anchored(msgs, F_OPS, lambda: tail_slice_starts(ops_src, "unpack")),
        "backend host()": _anchored(msgs, F_BACKEND, lambda: tail_slice_starts(back_src, "host")),
    }
    if cu_chain is not None and chain is not None and pack is not None \
            and None not in starts.values():
        msgs.extend(check_tail_chain(cu_chain, chain[0], chain[1], pack, starts))
    return _msgs_to_findings(
        msgs, "scal-cols", F_LAYOUT, (F_CUDA, F_KERNEL, F_OPS, F_BACKEND)
    )


def _carry_fixture(imp=importlib.import_module):
    """Smallest real binding: the audio workload on a random single-NoC
    design (seed 7), alloc menu over deliberately non-pow2 capacities (a
    pow2 assumption hiding in a width computation must not pass by luck),
    on the CPU."""
    core = imp("repro_torch.core")
    EncodedDesign = imp("repro_torch.core.phase_sim_torch").EncodedDesign

    db = core.HardwareDatabase()
    g = core.audio()
    d = core.random_single_noc_designs(g, 1, seed=7)[0]
    runner = core.DeviceChainRunner(g, db, device="cpu")
    ed = EncodedDesign.of(d, g, db, runner.enc)
    cap_pe = int(ed.pe_peak.shape[0]) + 3
    cap_mem = int(ed.mem_bw.shape[0]) + 2
    return runner, d, ed, cap_pe, cap_mem


PE_COLS = ("pe_bneck", "pe_active", "pe_peak", "pe_pj", "pe_leak",
           "pe_area", "pe_noc", "pe_rung", "pe_src")
MEM_COLS = ("mem_bneck", "mem_active", "mem_bw", "mem_pj", "mem_leak",
            "mem_area_fixed", "mem_area_per_mb", "mem_noc", "mem_rung",
            "mem_src")


def _check_carry(root: str) -> List[Finding]:
    msgs: List[str] = []
    state = state_tuple_fields(_src(root, F_DEVEXP))
    if state is None:
        msgs.append("could not locate the module-level `_STATE = (...)` "
                    "tuple — the chain-carry contract lost its anchor")
    with _port_at(root) as imp:
        dx = imp("repro_torch.core.device_explore")
        runner, d, ed, cap_pe, cap_mem = _carry_fixture(imp)
        table = dx.MoveTable.of(
            ed, runner.enc, alloc=True, cap_pe=cap_pe, cap_mem=cap_mem
        )
        carry = runner.fresh_carry(
            d, ed, r=2, seed=0, cap_pe=cap_pe, cap_mem=cap_mem, alloc=True
        )
        fields = dx.ChainCarry._fields
    msgs.extend(check_chain_carry(
        field_names=fields,
        taboo_width=int(carry.taboo.shape[1]),
        n_moves=table.n_moves,
        pe_widths={c: int(getattr(carry, c).shape[1]) for c in PE_COLS},
        cap_pe=cap_pe,
        mem_widths={c: int(getattr(carry, c).shape[1]) for c in MEM_COLS},
        cap_mem=cap_mem,
        state_fields=state,
    ))
    if len(carry) != len(fields):
        msgs.append(
            f"fresh_carry returned {len(carry)} leaves for a "
            f"{len(fields)}-field ChainCarry"
        )
    t = len(runner.enc.names)
    if tuple(carry.accel.shape) != (2, t, cap_pe):
        msgs.append(
            f"carry.accel shape {tuple(carry.accel.shape)} != (R, T, "
            f"cap_pe) = (2, {t}, {cap_pe})"
        )
    return _msgs_to_findings(msgs, "chain-carry", F_DEVEXP, ())


def move_codes(dx) -> Dict[str, int]:
    """The ``MV_*`` integer codes of a device_explore module."""
    return {
        n: int(getattr(dx, n))
        for n in dir(dx)
        if n.startswith("MV_") and isinstance(getattr(dx, n), int)
    }


def _check_moves(root: str) -> List[Finding]:
    msgs: List[str] = []
    dispatch = dispatch_mv_names(_src(root, F_DEVEXP))
    if dispatch is None:
        msgs.append("could not locate the chain step's `valid = (...)` "
                    "dispatch in `_step` — the move-codes contract lost its anchor")
    with _port_at(root) as imp:
        dx = imp("repro_torch.core.device_explore")
        msgs.extend(check_move_codes(
            codes=move_codes(dx),
            precedence_len=int(dx._KIND_PRECEDENCE.shape[0]),
            dispatch_names=dispatch or [],
        ))
    return _msgs_to_findings(msgs, "move-codes", F_DEVEXP, ())


def _check_policies(root: str) -> List[Finding]:
    doc_menus, doc_listed = _heuristics_doc_bindings(_src(root, F_HEUR))
    with _port_at(root) as imp:
        menus = imp("repro_torch.core.device_explore").MENUS
        policies = imp("repro_torch.core.policy").POLICIES
        msgs = check_policy_registry(
            policy_menus={n: cls.device_menu for n, cls in policies.items()},
            menus=menus,
            doc_menu_rows=doc_menus,
            doc_listed_policies=doc_listed,
        )
    return _msgs_to_findings(msgs, "policy-registry", F_POLICY, (F_HEUR, F_DEVEXP))


CONTRACTS: Tuple[Contract, ...] = (
    Contract(
        name="scal-cols",
        description="packed scal-column layout: the CUDA source's N_SCAL, "
        "rollup stores and tail offsets ↔ kernel.out_layout ↔ ops "
        "pack/unpack ↔ backend host unpack ↔ core.scal_layout",
        files=(F_LAYOUT, F_CUDA, F_KERNEL, F_OPS, F_BACKEND),
        check=_check_scal,
    ),
    Contract(
        name="chain-carry",
        description="ChainCarry leaves ↔ MoveTable row count ↔ fresh_carry "
        "widths ↔ _STATE coverage (the taboo-width class)",
        files=(F_DEVEXP,),
        check=_check_carry,
    ),
    Contract(
        name="move-codes",
        description="MV_* enumeration ↔ _KIND_PRECEDENCE ↔ the chain "
        "step's validity dispatch",
        files=(F_DEVEXP,),
        check=_check_moves,
    ),
    Contract(
        name="policy-registry",
        description="POLICIES ↔ device_menu eligibility ↔ MENUS ↔ both "
        "docs/HEURISTICS.md tables",
        files=(F_POLICY, F_HEUR, F_DEVEXP),
        check=_check_policies,
    ),
)


def run_contracts(
    names: Optional[Sequence[str]] = None,
    root: Optional[str] = None,
) -> List[Finding]:
    """Run the registry (or the named subset) on the tree at ``root``
    (default: this checkout) and return all findings."""
    out: List[Finding] = []
    for c in CONTRACTS:
        if names is not None and c.name not in names:
            continue
        out.extend(c.run(root))
    return out
