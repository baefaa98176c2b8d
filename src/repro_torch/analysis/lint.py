"""Torch lint: AST rules flagging host synchronisations and their kin in the
port's hot scopes.

The port's hot paths are eager torch: the chain block's K-step loop, the
phase-sim wrapper and its plain version, the MoE layer. A stray
``.item()``, ``float(tensor)`` or ``if torch.any(...)`` inside one waits
for the card and copies to the host on every call — the loop still
"works", at a host round trip per step, and a CUDA graph captured around it
would fail. This pass finds those *lexically*, before anything runs; the
launch audit (:mod:`~repro_torch.analysis.launch_audit`) checks what the
same paths really dispatch.

Eager torch has no trace to detect, so hot scopes are declared. A function
is **hot** when any of:

  * its ``def`` (any line of its signature) carries the marker comment
    ``# repro_torch: hot``;
  * it is lexically nested inside a hot function (helper closures,
    lambdas);
  * it is referenced from a hot function in the same module, by name or as
    ``self.<method>`` of the same class (one-module call-graph closure);
  * it is **captured**: decorated with or passed to ``torch.compile``,
    passed to ``make_graphed_callables`` or ``torch.utils.checkpoint
    .checkpoint``, or called inside a ``with torch.cuda.graph(...)`` block
    (and, by the same closure, whatever it reaches).

Rules (ids are what ``# repro_torch: noqa[<rule>]`` must name):

  ``host-sync``        in a hot scope: ``.item()``, ``.tolist()``,
                       ``.cpu()``, ``.numpy()``, ``.to("cpu")``;
                       ``float()``/``int()``/``bool()`` on a non-literal;
                       ``np.asarray``/``np.array``; ``torch.cuda
                       .synchronize()`` or ``.synchronize()`` on a stream
                       or event; and the ops whose output size depends on
                       the data (``nonzero``, ``argwhere``, one-argument
                       ``where``, ``unique``, ``unique_consecutive``,
                       ``masked_select``, ``bincount``) — each waits for
                       the device and copies to the host.
  ``tensor-branch``    Python ``if``/``while``/``assert``/ternary whose test
                       calls into ``torch.`` (bar the calls that return host
                       values: ``torch.cuda.*``, ``torch.is_tensor``,
                       ``torch.finfo``, …) or uses ``.any()``/``.all()`` —
                       in eager mode that test is a hidden
                       ``bool(tensor)``: a sync. Use ``torch.where``.
  ``f64-promote``      ``math.*`` calls, ``torch.float64``/``torch.double``,
                       ``.double()``, ``np.float64`` or a ``"float64"``
                       dtype in a hot scope — ``math`` on a tensor is a
                       host sync returning a Python f64; f64 operands
                       promote the f32 pipeline (and run at 1/64 rate on
                       the card).
  ``mutable-closure``  in a *captured* scope only: mutating a free
                       (closed-over) variable — ``xs.append(…)``,
                       ``cache[k] = v``, ``global``/``nonlocal``. A graph
                       replay or a compiled call does not re-run the
                       Python, and a checkpointed function re-runs it in
                       the recompute; in plain eager code the mutation runs
                       once per call, as written, so the rule says nothing
                       there.
  ``noqa-reason``      a ``# repro_torch: noqa[…]`` with no justification
                       text — suppressions must say why.

Suppression: append ``# repro_torch: noqa[rule]: reason`` to the offending
line. Existing debt is frozen (not hidden) in the checked-in baseline
(``src/repro_torch/analysis/baseline.json``, keyed on file+rule+line-text
so it survives line drift); ``python -m repro_torch.analysis
--update-baseline`` regenerates it, ``--strict`` fails on anything new.
"""
from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from .findings import Finding

__all__ = [
    "RULES",
    "lint_source",
    "lint_paths",
    "run_lint",
    "load_baseline",
    "apply_baseline",
    "write_baseline",
    "default_baseline_path",
    "default_lint_root",
]

RULES = {
    "host-sync": "device→host synchronisation inside a hot scope",
    "tensor-branch": "Python control flow on a tensor's value",
    "f64-promote": "f64-promoting host math inside a hot scope",
    "mutable-closure": "closed-over state mutated in a captured scope",
    "noqa-reason": "suppression without a justification string",
}

# names that capture a function (matched on the LAST attribute segment):
# compiled, replayed as a CUDA graph, or re-run by an activation checkpoint
_CAPTURE_NAMES = {"compile", "make_graphed_callables", "checkpoint"}

_NOQA_RE = re.compile(
    r"#\s*repro_torch:\s*noqa\[([A-Za-z0-9_,\- *]+)\]\s*:?\s*(.*)$"
)
_HOT_MARK_RE = re.compile(r"#\s*repro_torch:\s*hot\b")

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_DefNode = (ast.FunctionDef, ast.AsyncFunctionDef)

# attribute calls that pull a tensor's value to the host
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# ops whose output size depends on the data: the host waits for the count
_DATA_SIZED = {
    "nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
    "bincount",
}
# torch calls that return host values (a branch on them reads no tensor)
_HOST_TORCH_CALLS = {
    "device", "Size", "finfo", "iinfo", "get_default_dtype", "promote_types",
    "result_type", "is_tensor", "is_storage", "is_floating_point",
    "is_complex", "is_grad_enabled", "is_inference_mode_enabled",
    "is_autocast_enabled",
}
_HOST_TORCH_MODULES = {"cuda", "backends", "distributed", "jit", "compiler", "version"}
_NP_HOST_FNS = {"asarray", "array"}
_NP_ROOTS = {"np", "numpy", "onp"}
_MUTATOR_METHODS = {
    "append", "extend", "insert", "update", "add", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "appendleft", "extendleft",
}


def _last_name(node: ast.expr) -> Optional[str]:
    """Trailing identifier of a Name/Attribute chain (``torch.cuda.graph``
    → ``graph``), or None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _chain(node: ast.expr) -> List[str]:
    """The identifiers of a Name/Attribute chain, root first
    (``torch.cuda.synchronize`` → ``["torch", "cuda", "synchronize"]``);
    empty where the root is not a name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return []
    parts.append(node.id)
    return parts[::-1]


def _walk_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Every node of one function scope: descendants of ``node``, not
    entering nested defs or lambdas (those are scopes of their own)."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(child, _FuncNode):
            yield from _walk_scope(child)


def _scope_body(fn: ast.AST) -> List[ast.AST]:
    return [fn.body] if isinstance(fn, ast.Lambda) else list(fn.body)


class _Scopes:
    """Lexical function-scope index of one module: parents, name tables,
    each method's class, and simple aliases (``f = g`` /
    ``f = partial(g, …)``)."""

    def __init__(self, tree: ast.Module) -> None:
        self.tree = tree
        self.parent: Dict[ast.AST, Optional[ast.AST]] = {tree: None}
        self.defs: List[ast.AST] = []
        # (enclosing scope node, name) -> def node
        self.by_name: Dict[Tuple[ast.AST, str], ast.AST] = {}
        # (class node, method name) -> def node; def node -> its class
        self.methods: Dict[Tuple[ast.AST, str], ast.AST] = {}
        self.cls_of: Dict[ast.AST, ast.AST] = {}
        self._index(tree, tree, None)

    def _index(self, node: ast.AST, scope: ast.AST, cls: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            self.parent[child] = node
            if isinstance(child, _FuncNode):
                self.defs.append(child)
                if isinstance(child, _DefNode):
                    if cls is not None and node is cls:
                        self.methods[(cls, child.name)] = child
                        self.cls_of[child] = cls
                    else:
                        self.by_name[(scope, child.name)] = child
                self._index(child, child, None)
            elif isinstance(child, ast.ClassDef):
                self._index(child, scope, child)
            else:
                if isinstance(child, ast.Assign) and len(child.targets) == 1 \
                        and isinstance(child.targets[0], ast.Name):
                    alias = _alias_of(child.value)
                    hit = self._resolve_from(scope, alias) if alias else None
                    if hit is not None:
                        self.by_name[(scope, child.targets[0].id)] = hit
                self._index(child, scope, cls)

    def enclosing(self, node: ast.AST) -> ast.AST:
        """Nearest enclosing function scope (or the module)."""
        cur = self.parent.get(node)
        while cur is not None and not isinstance(cur, _FuncNode):
            cur = self.parent.get(cur)
        return cur if cur is not None else self.tree

    def _resolve_from(self, scope: ast.AST, name: str) -> Optional[ast.AST]:
        cur: Optional[ast.AST] = scope
        while cur is not None:
            hit = self.by_name.get((cur, name))
            if hit is not None:
                return hit
            cur = self.parent.get(cur)
            while cur is not None and not isinstance(cur, _FuncNode + (ast.Module,)):
                cur = self.parent.get(cur)
        return None

    def resolve(self, at: ast.AST, node: ast.expr) -> Optional[ast.AST]:
        """The def a Name load, or a ``self.<method>`` attribute, refers to."""
        if isinstance(node, ast.Name):
            return self._resolve_from(self.enclosing(at), node.id)
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            fn = self.enclosing(at)
            while fn is not None and fn not in self.cls_of and fn is not self.tree:
                fn = self.enclosing(fn)
            cls = self.cls_of.get(fn)
            return self.methods.get((cls, node.attr)) if cls is not None else None
        return None


def _alias_of(v: ast.expr) -> Optional[str]:
    if isinstance(v, ast.Name):
        return v.id
    if (isinstance(v, ast.Call) and _last_name(v.func) == "partial" and v.args
            and isinstance(v.args[0], ast.Name)):
        return v.args[0].id
    return None


def _fn_arg(scopes: _Scopes, at: ast.AST, arg: ast.expr) -> Optional[ast.AST]:
    """The def a function-valued argument names: a lambda, a name, a
    ``self.<method>``, or ``partial(<one of those>, …)``."""
    if isinstance(arg, ast.Lambda):
        return arg
    if isinstance(arg, ast.Call) and _last_name(arg.func) == "partial" and arg.args:
        arg = arg.args[0]
    return scopes.resolve(at, arg)


def _hot_defs(tree: ast.Module, scopes: _Scopes,
              lines: List[str]) -> Tuple[Set[ast.AST], Set[ast.AST]]:
    """(hot scopes, captured scopes); captured ⊆ hot."""
    hot: Set[ast.AST] = set()
    captured: Set[ast.AST] = set()

    # 1. the marker on a def's signature lines, and @torch.compile
    for d in scopes.defs:
        if not isinstance(d, _DefNode):
            continue
        sig_end = d.body[0].lineno - 1 if d.body else d.lineno
        if any(_HOT_MARK_RE.search(lines[ln - 1])
               for ln in range(d.lineno, max(sig_end, d.lineno) + 1)
               if 0 < ln <= len(lines)):
            hot.add(d)
        for dec in d.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _last_name(target) == "compile":
                captured.add(d)

    # 2. functions handed to a capturing call, or called inside a
    # `with torch.cuda.graph(...)` block
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _last_name(node.func) in _CAPTURE_NAMES:
            args = node.args[:1]
            if args and isinstance(args[0], (ast.Tuple, ast.List)):
                args = list(args[0].elts)  # make_graphed_callables((f, g), …)
            for arg in args:
                hit = _fn_arg(scopes, node, arg)
                if hit is not None:
                    captured.add(hit)
        elif isinstance(node, ast.With) and any(
            isinstance(it.context_expr, ast.Call)
            and _chain(it.context_expr.func)[-2:] == ["cuda", "graph"]
            for it in node.items
        ):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        hit = scopes.resolve(node, sub.func)
                        if hit is not None:
                            captured.add(hit)

    # 3. closure: lexical nesting + same-module references
    _close(scopes, captured)
    hot |= captured
    _close(scopes, hot)
    return hot, captured


def _close(scopes: _Scopes, marked: Set[ast.AST]) -> None:
    """Grow ``marked`` by the defs nested in it and the defs its bodies
    name (``f`` or ``self.f``), to a fixed point."""
    changed = True
    while changed:
        changed = False
        for d in scopes.defs:
            if d in marked:
                continue
            cur = scopes.parent.get(d)
            while cur is not None:
                if cur in marked:
                    marked.add(d)
                    changed = True
                    break
                cur = scopes.parent.get(cur)
        for d in list(marked):
            for node in ast.walk(d):
                if isinstance(getattr(node, "ctx", None), ast.Load):
                    hit = scopes.resolve(node, node)
                    if hit is not None and hit not in marked:
                        marked.add(hit)
                        changed = True


def _local_bindings(fn: ast.AST) -> Set[str]:
    """Names a function binds itself: params + any Store/target inside it
    (excluding nested function bodies — those have their own scopes)."""
    args = fn.args
    names = {a.arg for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    if isinstance(fn, ast.Lambda):
        return names
    for node in _walk_scope(fn):
        if isinstance(node, _DefNode):
            names.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store, ast.Del)):
            names.add(node.id)
    return names


def _torch_tensor_call(call: ast.Call) -> bool:
    """A ``torch.``-rooted call that returns a tensor (not a host value)."""
    chain = _chain(call.func)
    if len(chain) < 2 or chain[0] != "torch":
        return False
    return not (chain[-1] in _HOST_TORCH_CALLS or chain[1] in _HOST_TORCH_MODULES)


def _tests_a_tensor(node: ast.expr) -> bool:
    """Does a branch test read a tensor's value? Narrow on purpose:
    ``torch.``-rooted calls that return tensors and ``.any()``/``.all()``
    reductions. Static-config branches (``if self.menu == "farsi"``,
    ``if dev.type == "cuda"``) and dtype comparisons stay legal."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        if _torch_tensor_call(sub):
            return True
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in ("any", "all") \
                and not sub.args:
            return True
    return False


def _is_f64(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant) and node.value in ("float64", "double"):
        return True
    chain = _chain(node)
    return len(chain) == 2 and (
        (chain[0] == "torch" and chain[1] in ("float64", "double"))
        or (chain[0] in _NP_ROOTS and chain[1] == "float64"))


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    vals = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and isinstance(v.value, str)
               and v.value.startswith("cpu") for v in vals)


def _lint_hot_fn(
    fn: ast.AST, captured: bool, path: str, lines: List[str], out: List[Finding]
) -> None:
    free_guard = _local_bindings(fn) if captured else set()

    def emit(rule: str, node: ast.AST, msg: str) -> None:
        line = getattr(node, "lineno", 0)
        src = lines[line - 1].strip() if 0 < line <= len(lines) else ""
        out.append(Finding(
            pass_name="lint", rule=rule, message=msg, path=path,
            line=line, source=src,
        ))

    for stmt in _scope_body(fn):
        if isinstance(stmt, _FuncNode):
            continue  # a nested def is a scope of its own
        for node in [stmt, *_walk_scope(stmt)]:
            if isinstance(node, _FuncNode):
                continue  # so is a lambda
            if isinstance(node, ast.Call):
                _lint_call(node, emit)
                if captured:
                    _lint_mutation_call(node, free_guard, emit)
            elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                if _tests_a_tensor(node.test):
                    emit("tensor-branch", node,
                         "Python control flow on a tensor's value is a hidden "
                         "`bool(tensor)`: a host sync every call — use "
                         "torch.where / a masked write")
            elif isinstance(node, ast.Attribute) and _is_f64(node):
                emit("f64-promote", node,
                     f"`{ast.unparse(node)}` in a hot scope promotes the f32 "
                     "pipeline to f64")
            elif captured and isinstance(node, (ast.Global, ast.Nonlocal)):
                emit("mutable-closure", node,
                     f"`{'global' if isinstance(node, ast.Global) else 'nonlocal'}`"
                     " write-through in a captured scope runs at capture (or "
                     "again in the recompute), not per replay")
            elif captured and isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                            and t.value.id not in free_guard:
                        emit("mutable-closure", node,
                             f"subscript store into closed-over `{t.value.id}` "
                             "in a captured scope runs at capture, not per replay")


def _lint_call(node: ast.Call, emit) -> None:
    fname = _last_name(node.func)
    chain = _chain(node.func)
    attr = isinstance(node.func, ast.Attribute)
    if isinstance(node.func, ast.Name) and fname in ("float", "int", "bool") \
            and node.args and not isinstance(node.args[0], ast.Constant):
        emit("host-sync", node,
             f"`{fname}()` on a tensor waits for the device and copies its "
             "value to the host (keep it a tensor; a Python number here "
             "needs a noqa saying why it is one)")
    elif attr and fname in _HOST_METHODS:
        emit("host-sync", node,
             f"`.{fname}()` copies to the host inside a hot scope")
    elif attr and fname == "to" and _to_cpu(node):
        emit("host-sync", node, "`.to(\"cpu\")` copies to the host inside a hot scope")
    elif attr and fname == "synchronize":
        emit("host-sync", node,
             f"`{ast.unparse(node.func)}()` blocks the host on the device "
             "— it has no place inside a hot scope")
    elif attr and (fname in _DATA_SIZED or (
            fname == "where" and len(node.args) == 1 and not node.keywords)):
        emit("host-sync", node,
             f"`{fname}` sizes its output from the data: the host waits for "
             "the count (use a fixed-size form: a mask, a scatter-add)")
    elif len(chain) == 2 and chain[0] in _NP_ROOTS and fname in _NP_HOST_FNS:
        emit("host-sync", node,
             f"`{chain[0]}.{fname}` materializes a tensor on the host")
    elif chain[:1] == ["math"]:
        emit("f64-promote", node,
             f"`math.{fname}` on a tensor syncs and returns a Python float "
             "(f64) — use torch ops")
    elif attr and fname == "double" and not node.args:
        emit("f64-promote", node, "`.double()` promotes the f32 pipeline to f64")
    for kw in node.keywords:
        if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) and _is_f64(kw.value):
            emit("f64-promote", node, "explicit float64 dtype inside a hot scope")


def _lint_mutation_call(node: ast.Call, free_guard: Set[str], emit) -> None:
    fname = _last_name(node.func)
    if fname in _MUTATOR_METHODS and isinstance(node.func, ast.Attribute) \
            and isinstance(node.func.value, ast.Name) \
            and node.func.value.id not in free_guard:
        target = node.func.value.id
        emit("mutable-closure", node,
             f"`{target}.{fname}(…)` mutates closed-over state in a captured "
             "scope: a replay does not re-run it (a recompute runs it again)")


def _noqa_filter(
    findings: List[Finding], lines: List[str], path: str
) -> List[Finding]:
    """Apply per-line `# repro_torch: noqa[rule]` suppressions; a
    suppression with no reason text surfaces as its own ``noqa-reason``
    finding."""
    out: List[Finding] = []
    reason_flagged: Set[int] = set()
    for f in findings:
        line_txt = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        m = _NOQA_RE.search(line_txt)
        if m:
            named = {r.strip() for r in m.group(1).split(",")}
            if f.rule in named or "*" in named:
                f = Finding(**{**f.__dict__, "suppressed": True})
                if not m.group(2).strip() and f.line not in reason_flagged:
                    reason_flagged.add(f.line)
                    out.append(Finding(
                        pass_name="lint", rule="noqa-reason",
                        message="suppression has no justification — add "
                        "`# repro_torch: noqa[rule]: <why>`",
                        path=path, line=f.line, source=line_txt.strip(),
                    ))
        out.append(f)
    return out


def lint_source(src: str, path: str = "<memory>") -> List[Finding]:
    """Lint one module's source text. The unit tests drive this directly
    with fixture snippets; :func:`lint_paths` feeds it files."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(
            pass_name="lint", rule="host-sync",
            message=f"unparseable module: {e}", path=path,
            line=e.lineno or 0,
        )]
    lines = src.splitlines()
    scopes = _Scopes(tree)
    hot, captured = _hot_defs(tree, scopes, lines)
    findings: List[Finding] = []
    for fn in hot:
        _lint_hot_fn(fn, fn in captured, path, lines, findings)
    # a (line, rule) can be reached through several hot parents after the
    # call-graph closure — report it once
    seen: Set[Tuple[int, str, str]] = set()
    deduped = []
    for f in sorted(findings, key=lambda f: (f.line, f.rule, f.message)):
        k = (f.line, f.rule, f.message)
        if k in seen:
            continue
        seen.add(k)
        deduped.append(f)
    return _noqa_filter(deduped, lines, path)


def default_lint_root() -> str:
    """``src/repro_torch`` as shipped: the parent of this package."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def _rel(path: str, root: str) -> str:
    # stable repo-relative keys: src/repro_torch/… regardless of install layout
    rp = os.path.relpath(path, os.path.dirname(os.path.dirname(root)))
    return rp.replace(os.sep, "/")


def lint_paths(paths: Iterable[str], root: Optional[str] = None) -> List[Finding]:
    root = root or default_lint_root()
    out: List[Finding] = []
    for p in paths:
        with open(p, "r", encoding="utf-8") as fh:
            src = fh.read()
        out.extend(lint_source(src, path=_rel(p, root)))
    return out


def run_lint(root: Optional[str] = None) -> List[Finding]:
    """Lint every ``.py`` under ``src/repro_torch/`` (excluding this package
    — the analyzer's own fixtures would trip the rules; the CUDA sources
    are the contracts' subject, not the lint's)."""
    root = root or default_lint_root()
    files: List[str] = []
    skip_dir = os.path.abspath(os.path.join(root, "analysis"))
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        if os.path.abspath(dirpath).startswith(skip_dir):
            continue
        files.extend(os.path.join(dirpath, fn) for fn in filenames if fn.endswith(".py"))
    return lint_paths(sorted(files), root=root)


# ---------------------------------------------------------------------------
# baseline: freeze existing debt without hiding it
# ---------------------------------------------------------------------------
def load_baseline(path: Optional[str] = None) -> Dict[str, int]:
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def apply_baseline(
    findings: List[Finding], baseline: Dict[str, int]
) -> List[Finding]:
    """Mark up to ``baseline[key]`` occurrences of each key as baselined
    (never suppressed ones — those are already accounted for)."""
    budget = dict(baseline)
    out: List[Finding] = []
    for f in findings:
        if not f.suppressed and budget.get(f.key(), 0) > 0:
            budget[f.key()] -= 1
            f = Finding(**{**f.__dict__, "baselined": True})
        out.append(f)
    return out


def write_baseline(
    findings: List[Finding], path: Optional[str] = None
) -> str:
    path = path or default_baseline_path()
    counts: Dict[str, int] = {}
    for f in findings:
        if f.suppressed or f.rule == "noqa-reason":
            continue
        counts[f.key()] = counts.get(f.key(), 0) + 1
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {"comment": "frozen lint debt — python -m repro_torch.analysis "
             "--update-baseline regenerates; tier-1 asserts this stays "
             "EMPTY for src/repro_torch/core/, kernels/phase_sim/ and "
             "models/moe.py",
             "findings": dict(sorted(counts.items()))},
            fh, indent=1, sort_keys=False,
        )
        fh.write("\n")
    return path
