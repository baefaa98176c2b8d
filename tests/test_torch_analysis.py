"""repro_torch.analysis acceptance pins, mirroring tests/test_analysis.py.

Every pass must (a) run clean on the shipped tree and (b) demonstrably fail
on a seeded mutation of the exact bug class it was built for: a reordered
SCAL_PREFIX, an ``N_SCAL`` or a rollup store moved in the hand-written
CUDA source, a narrowed taboo column, an ``MV_*`` code dropped from the
step's ``valid``, a policy's ``device_menu`` changed — each on a copy of the
tree — must trip the contract checker with a finding naming every file
involved; a ``float()`` injected into the chain step must trip the lint; an
``.item()`` injected into the step must trip the launch audit's op log. The
lint rules are pinned per rule with trigger / no-trigger snippets. The
second half holds the port's bound values and pure checks against the
reference's (``repro.analysis``) on the same inputs.
"""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import contracts as ref_contracts  # noqa: E402
from repro_torch.analysis import contracts as C  # noqa: E402
from repro_torch.analysis.findings import Finding  # noqa: E402
from repro_torch.analysis.lint import apply_baseline, lint_source, write_baseline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
DEVEXP = os.path.join(PORT, "core", "device_explore.py")
CUDA = os.path.join(PORT, "kernels", "phase_sim", "csrc", "phase_sim.cu")


def _read(path):
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def _live(findings, rule=None):
    return [f for f in findings if f.live and (rule is None or f.rule == rule)]


# ---------------------------------------------------------------------------
# lint rules: one trigger and one no-trigger snippet each
# ---------------------------------------------------------------------------
def test_lint_host_sync_float_in_hot_fn():
    src = (
        "def f(x):  # repro_torch: hot\n"
        "    return float(x) + 1\n"
    )
    assert _live(lint_source(src), "host-sync")


def test_lint_host_sync_item_tolist_cpu_numpy_asarray():
    src = (
        "import numpy as np\n"
        "def step(c, x):  # repro_torch: hot\n"
        "    v = c.item()\n"
        "    w = np.asarray(x)\n"
        "    a = c.tolist()\n"
        "    b = x.cpu()\n"
        "    d = x.numpy()\n"
        "    return v, w, a, b, d\n"
    )
    assert len(_live(lint_source(src), "host-sync")) == 5


def test_lint_host_sync_synchronize_and_data_sized_ops():
    """``bincount`` sizes its output on the host: every data-sized op is a
    sync, and so is a stream's ``synchronize``."""
    src = (
        "import torch\n"
        "def f(x, stream):  # repro_torch: hot\n"
        "    torch.cuda.synchronize()\n"
        "    stream.synchronize()\n"
        "    a = torch.nonzero(x)\n"
        "    b = x.unique()\n"
        "    c = torch.masked_select(x, x > 0)\n"
        "    d = x.bincount()\n"
        "    e = torch.where(x > 0)\n"
        "    g = x.to('cpu')\n"
        "    return a, b, c, d, e, g\n"
    )
    lines = {f.line for f in _live(lint_source(src), "host-sync")}
    assert lines == set(range(3, 11)), lines


def test_lint_three_argument_where_ok():
    src = (
        "import torch\n"
        "def f(x):  # repro_torch: hot\n"
        "    return torch.where(x > 0, x, 0), x.to('cuda'), x.to(torch.float32)\n"
    )
    assert not _live(lint_source(src))


def test_lint_host_sync_not_outside_hot_scope():
    src = (
        "def host_only(x):\n"
        "    return float(x), x.item()\n"
    )
    assert not _live(lint_source(src))


def test_lint_host_sync_float_on_literal_ok():
    src = (
        "def f(x):  # repro_torch: hot\n"
        "    return x * float('inf')\n"
    )
    assert not _live(lint_source(src), "host-sync")


def test_lint_tensor_branch_flags_torch_call_test():
    src = (
        "import torch\n"
        "def f(x):  # repro_torch: hot\n"
        "    if torch.sum(x) > 0:\n"
        "        return x\n"
        "    return -x\n"
    )
    assert _live(lint_source(src), "tensor-branch")


def test_lint_tensor_branch_any_all():
    src = (
        "def f(x):  # repro_torch: hot\n"
        "    while (x > 0).any():\n"
        "        x = x - 1\n"
        "    assert x.all()\n"
        "    return x if x.any() else -x\n"
    )
    assert len(_live(lint_source(src), "tensor-branch")) == 3


def test_lint_tensor_branch_static_config_ok():
    # static-config branches, host-valued torch calls and dtype comparisons
    # are the shipped idiom (the chain step branches on its menu)
    src = (
        "import torch\n"
        "def f(x, n_noc=1, menu='farsi'):  # repro_torch: hot\n"
        "    if n_noc == 1:\n"
        "        x = x + 1\n"
        "    if menu in ('farsi', 'telemetry'):\n"
        "        x = x * 2\n"
        "    if torch.cuda.is_available() and torch.is_tensor(x):\n"
        "        x = x * 3\n"
        "    return x if x.dtype == torch.float32 else x.to(torch.float32)\n"
    )
    assert not _live(lint_source(src))


def test_lint_f64_promote_math_call():
    src = (
        "import math\n"
        "def f(x):  # repro_torch: hot\n"
        "    return math.exp(x) + math.inf\n"
    )
    assert len(_live(lint_source(src), "f64-promote")) == 1  # math.inf is a constant


def test_lint_f64_promote_dtypes():
    src = (
        "import torch, numpy as np\n"
        "def f(x):  # repro_torch: hot\n"
        "    a = x.to(torch.float64)\n"
        "    b = x.double()\n"
        "    c = np.float64(1.0)\n"
        "    d = torch.zeros((3,), dtype='float64')\n"
        "    return a, b, c, d\n"
    )
    lines = {f.line for f in _live(lint_source(src), "f64-promote")}
    assert lines == {3, 4, 5, 6}, lines


def test_lint_mutable_closure_not_in_eager_hot_scope():
    # eager code runs the mutation once per call, as written
    src = (
        "acc = []\n"
        "def f(x):  # repro_torch: hot\n"
        "    acc.append(x)\n"
        "    return x\n"
    )
    assert not _live(lint_source(src))


@pytest.mark.parametrize("capture", [
    "@torch.compile\ndef f(x):\n    acc.append(x)\n    return x\n",
    "def f(x):\n    acc.append(x)\n    return x\ng = torch.compile(f)\n",
    "def f(x):\n    acc.append(x)\n    return x\ndef cap(gr, x):\n    with torch.cuda.graph(gr):\n        f(x)\n",
    "def f(x):\n    acc.append(x)\n    return x\ng = torch.cuda.make_graphed_callables(f, (torch.ones(1),))\n",
    "def f(x):\n    acc.append(x)\n    return x\ndef fwd(x):\n    return checkpoint(f, x, use_reentrant=False)\n",
], ids=["compile-decorator", "compile-call", "cuda-graph", "graphed-callables", "checkpoint"])
def test_lint_mutable_closure_in_captured_scope(capture):
    src = "import torch\nfrom torch.utils.checkpoint import checkpoint\nacc = []\n" + capture
    assert _live(lint_source(src), "mutable-closure")


def test_lint_mutable_closure_local_list_ok():
    src = (
        "import torch\n"
        "@torch.compile\n"
        "def f(x):\n"
        "    acc = []\n"
        "    acc.append(x)\n"
        "    return x\n"
    )
    assert not _live(lint_source(src), "mutable-closure")


def test_lint_hot_marker_on_a_multi_line_signature():
    src = (
        "def hot(a,\n"
        "        b):  # repro_torch: hot\n"
        "    return float(a)\n"
    )
    assert _live(lint_source(src), "host-sync")


def test_lint_call_graph_closure_marks_callees():
    # a same-module helper named from a hot function, a nested def, and a
    # method reached as self.<name> all inherit the hot scope
    src = (
        "import torch\n"
        "def helper(x):\n"
        "    return float(x)\n"
        "class Block:\n"
        "    def _apply(self, x):\n"
        "        return x.item()\n"
        "    def cold(self, x):\n"
        "        return x.item()\n"
        "    def _step(self, xs):  # repro_torch: hot\n"
        "        def inner(y):\n"
        "            return y.tolist()\n"
        "        return torch.stack([helper(x) for x in xs]), self._apply(xs), inner(xs)\n"
    )
    lines = {f.line for f in _live(lint_source(src), "host-sync")}
    assert lines == {3, 6, 11}, lines


# ---------------------------------------------------------------------------
# suppression + baseline machinery
# ---------------------------------------------------------------------------
def test_noqa_suppresses_with_reason():
    src = (
        "def f(x):  # repro_torch: hot\n"
        "    return float(x)  # repro_torch: noqa[host-sync]: x is a Python int here\n"
    )
    fs = lint_source(src)
    assert not _live(fs)
    assert any(f.suppressed for f in fs)


def test_noqa_without_reason_is_its_own_finding():
    src = (
        "def f(x):  # repro_torch: hot\n"
        "    return float(x)  # repro_torch: noqa[host-sync]\n"
    )
    assert _live(lint_source(src), "noqa-reason")


def test_noqa_wrong_rule_does_not_suppress():
    src = (
        "def f(x):  # repro_torch: hot\n"
        "    return float(x)  # repro_torch: noqa[f64-promote]: wrong rule\n"
    )
    assert _live(lint_source(src), "host-sync")


def test_baseline_roundtrip(tmp_path):
    src = (
        "def f(x):  # repro_torch: hot\n"
        "    return float(x)\n"
    )
    findings = lint_source(src, path="src/repro_torch/x.py")
    p = tmp_path / "baseline.json"
    write_baseline(findings, str(p))
    base = json.loads(p.read_text())["findings"]
    after = apply_baseline(lint_source(src, path="src/repro_torch/x.py"), base)
    assert not _live(after)
    assert any(f.baselined for f in after)
    # a NEW finding in the same file stays live
    src2 = src + "\ndef g(y):  # repro_torch: hot\n    return float(y)\n"
    after2 = apply_baseline(lint_source(src2, path="src/repro_torch/x.py"), base)
    assert _live(after2)


def test_shipped_baseline_is_empty_for_the_hot_path():
    """The frozen lint debt holds nothing under core/ or kernels/phase_sim/
    and nothing in models/moe.py."""
    with open(os.path.join(PORT, "analysis", "baseline.json")) as fh:
        frozen = json.load(fh)["findings"]
    hot = ("src/repro_torch/core/", "src/repro_torch/kernels/phase_sim/",
           "src/repro_torch/models/moe.py")
    assert not {k: v for k, v in frozen.items() if k.startswith(hot)}, frozen


def test_shipped_tree_lints_clean():
    from repro_torch.analysis.lint import load_baseline, run_lint

    live = _live(apply_baseline(run_lint(), load_baseline()))
    assert not live, "\n".join(f.render() for f in live)


@pytest.mark.parametrize("module,names", [
    ("core/device_explore.py", {"_step", "_iterate", "_apply_move", "block_draws"}),
    ("kernels/phase_sim/chain.py", {"resimulate_chains"}),
    ("kernels/phase_sim/ops.py", {"phase_sim_rows", "phase_sim", "unpack", "pack_plain"}),
    ("core/phase_sim_torch.py", {"phase_sim_plain"}),
    ("models/moe.py", {"moe_apply", "capacity"}),
])
def test_shipped_hot_scopes(module, names):
    """The scopes the card proves free of syncs, and the pricing cores, are
    hot — marked, or reached from a marked scope."""
    from repro_torch.analysis import lint as L

    src = _read(os.path.join(PORT, module))
    tree = ast.parse(src)
    hot, _ = L._hot_defs(tree, L._Scopes(tree), src.splitlines())
    got = {getattr(d, "name", None) for d in hot}
    assert names <= got, names - got


def test_injected_host_sync_in_chain_step_is_caught():
    """Textually seed a ``float(...)`` host sync into the chain step and a
    ``.item()`` into the K-step loop: the lint flags both."""
    src = _read(DEVEXP)
    step = "        taboo = (c.taboo - 1).clamp(min=0)\n"
    loop = "        c = carry._replace(key=key)\n"
    assert step in src and loop in src
    mutated = src.replace(step, step + "        _leak = float(c.fitness[0])\n", 1)
    mutated = mutated.replace(loop, loop + "        _n = u.sum().item()\n", 1)
    hits = _live(lint_source(mutated, path="src/repro_torch/core/device_explore.py"), "host-sync")
    assert {"_leak = float(c.fitness[0])", "_n = u.sum().item()"} <= {f.source for f in hits}


# ---------------------------------------------------------------------------
# contracts: pure checks on deliberately-desynced inputs
# ---------------------------------------------------------------------------
_COLS = (
    "latency_s", "energy_j", "power_w", "area_mm2", "fitness",
    "alp_time_s", "traffic_bytes", "n_phases", "all_done",
    "kind_pe_s", "kind_mem_s", "kind_noc_s", "top_bneck_pe", "top_bneck_mem",
)


def test_contract_scal_cols_clean():
    assert not C.check_scal_cols(_COLS, _COLS, _COLS[:9], 14, 14)


def test_contract_scal_cols_reorder_trips():
    swapped = list(_COLS)
    swapped[4], swapped[5] = swapped[5], swapped[4]
    assert C.check_scal_cols(_COLS, tuple(swapped), _COLS[:9], 14, 14)


def test_contract_scal_cols_width_drift_trips():
    assert C.check_scal_cols(_COLS, _COLS, _COLS[:9], 13, 14)
    assert C.check_scal_cols(_COLS, _COLS, _COLS[:9], 14, 13)


def test_contract_rollup_anchors_on_the_cuda_source():
    """A reorder of the single-sourced schema passes the name-diff
    tautologically: the anchors catch it against the CUDA source's
    positional stores."""
    rollup = C.cuda_rollup_sources(_read(CUDA))
    assert len(rollup) == 14
    assert not C.check_rollup_anchors(_COLS, rollup)  # the shipped order holds
    swapped = list(_COLS)
    swapped[0], swapped[1] = swapped[1], swapped[0]  # latency_s ↔ energy_j
    assert C.check_rollup_anchors(tuple(swapped), rollup)
    swapped2 = list(_COLS)
    swapped2[4], swapped2[6] = swapped2[6], swapped2[4]  # fitness ↔ traffic
    assert C.check_rollup_anchors(tuple(swapped2), rollup)


def test_cuda_extractors_bind():
    src = _read(CUDA)
    assert C.cuda_n_scal(src) == 14
    assert C.cuda_tail_chain(src) == [
        ("pe", "N_SCAL"), ("mem", "s_pe"), ("noc", "s_mem"), ("wl", "n_noc"),
        ("fin", "n_wl"), ("bn", "t"),
    ]
    chain, keys = C.layout_chain(_read(os.path.join(PORT, "kernels", "phase_sim", "kernel.py")))
    assert chain == C.cuda_tail_chain(src)
    assert keys["finish"] == "fin" and keys["scal_end"] == "wl"


@pytest.mark.parametrize("edit", [
    ("constexpr int N_SCAL = 14;", ""),  # the constant is gone
    ("constexpr int N_SCAL = 14;", "constexpr int N_SCAL = 14;\nconstexpr int N_SCAL = 15;"),
    ("    out[13] = (float)top_mem;\n", "    out[15] = (float)top_mem;\n"),  # a gap
    ("    out[13] = (float)top_mem;\n", "    out[12] = (float)top_mem;\n"),  # stored twice
    ("const int o_noc = o_mem + p.S_mem;", "const int o_noc = o_pe + p.S_mem;"),
    ("const int o_pe = N_SCAL;", "const int o_pe = 14;"),
], ids=["no-n-scal", "two-n-scal", "rollup-gap", "rollup-twice", "chain-break", "chain-base"])
def test_cuda_extractors_fail_loudly(edit):
    """A CUDA source that changed shape must read as a lost anchor — a
    finding — never as a clean pass."""
    src = _read(CUDA)
    assert edit[0] in src
    mutated = src.replace(edit[0], edit[1], 1)
    with pytest.raises(C.SourceShapeError):
        for extract in (C.cuda_n_scal, C.cuda_rollup_sources, C.cuda_tail_chain):
            extract(mutated)


def test_contract_tail_chain_trips():
    chain = [("pe", "N_SCAL"), ("mem", "s_pe"), ("noc", "s_mem"), ("wl", "n_noc"),
             ("fin", "n_wl"), ("bn", "t")]
    keys = {"pe": "pe", "mem": "mem", "noc": "noc", "scal_end": "wl", "wl": "wl",
            "finish": "fin", "bneck": "bn"}
    order = ["bneck_kind_s", "pe_bneck_s", "mem_bneck_s", "noc_bneck_s", "wl_latency_s",
             "finish_s", "bneck_code"]
    starts = {"ops.unpack": {"pe_bneck_s": "pe", "mem_bneck_s": "mem", "finish_s": "finish"}}
    assert not C.check_tail_chain(chain, chain, keys, order, starts)
    swapped = chain[:1] + [("mem", "s_mem"), ("noc", "s_pe")] + chain[3:]
    assert C.check_tail_chain(swapped, chain, keys, order, starts)
    assert C.check_tail_chain(chain, chain, keys, order[:1] + order[2:3] + order[1:2] + order[3:],
                              starts)
    assert C.check_tail_chain(chain, chain, keys, order,
                              {"ops.unpack": {"pe_bneck_s": "mem"}})


def test_contract_chain_carry_taboo_narrowed_trips():
    fields = C.CARRY_PREFIX + ("pe_active",)
    assert not C.check_chain_carry(fields, 120, 120, {"pe_active": 8}, 8, {}, 4)
    bad = C.check_chain_carry(fields, 119, 120, {"pe_active": 8}, 8, {}, 4)
    assert bad and any("taboo-width" in m for m in bad)


def test_contract_chain_carry_prefix_order_trips():
    fields = ("task_mem", "task_pe") + C.CARRY_PREFIX[2:]
    assert C.check_chain_carry(fields, 10, 10, {}, 4, {}, 4)


def test_contract_chain_carry_state_coverage_trips():
    fields = C.CARRY_PREFIX + ("pe_active", "accel")
    assert not C.check_chain_carry(
        fields, 10, 10, {}, 4, {}, 4,
        state_fields=("task_pe", "task_mem", "pe_active", "accel"))
    bad = C.check_chain_carry(
        fields, 10, 10, {}, 4, {}, 4,
        state_fields=("task_pe", "task_mem", "pe_active"))  # accel dropped
    assert bad and any("accel" in m for m in bad)


def test_contract_move_codes_clean_and_trips():
    codes = {"MV_MIG_PE": 0, "MV_MIG_MEM": 1, "MV_FORK_PE": 2, "MV_FORK_MEM": 3}
    assert not C.check_move_codes(codes, 4, list(codes))
    assert C.check_move_codes({**codes, "MV_FORK_MEM": 5}, 4, list(codes))  # sparse
    assert C.check_move_codes(  # parity convention
        {"MV_MIG_PE": 1, "MV_MIG_MEM": 0, "MV_FORK_PE": 2, "MV_FORK_MEM": 3}, 4, list(codes))
    assert C.check_move_codes(codes, 3, list(codes))  # precedence table too short
    assert C.check_move_codes(codes, 4, ["MV_MIG_PE", "MV_MIG_MEM"])  # dispatch forgets a kind


def test_contract_policy_registry_trips():
    menus = ("naive_sa", "telemetry", "farsi")
    pm = {"naive_sa": "naive_sa", "farsi": "farsi"}
    docs = dict(pm)
    assert not C.check_policy_registry(pm, menus, docs, list(pm))
    assert C.check_policy_registry({**pm, "farsi": "bogus"}, menus, docs, list(pm))
    assert C.check_policy_registry(pm, menus, {**docs, "farsi": "telemetry"}, list(pm))
    assert C.check_policy_registry(pm, menus, {"naive_sa": "naive_sa"}, ["naive_sa"])


def test_md_table_parser():
    text = (
        "prose\n\n"
        "| name | selection |\n|---|---|\n| `a` | x |\n| `b` / `c` | y |\n"
        "\nmore prose\n"
    )
    tables = C.parse_md_tables(text)
    assert len(tables) == 1
    assert tables[0][0] == ["name", "selection"]
    assert len(tables[0]) == 3


# ---------------------------------------------------------------------------
# contracts bound to the real tree, and to seeded desyncs of a copy of it
# ---------------------------------------------------------------------------
def test_contracts_hold_on_shipped_tree():
    findings = C.run_contracts()
    assert not findings, "\n".join(f.render() for f in findings)


def test_real_taboo_desync_is_caught():
    """The taboo-width regression against the REAL fresh_carry: a carry
    whose taboo column is narrower than the real move table is flagged by
    the same pure check the contract runs."""
    from repro_torch.core.device_explore import ChainCarry, MoveTable

    runner, d, ed, cap_pe, cap_mem = C._carry_fixture()
    table = MoveTable.of(ed, runner.enc, alloc=True, cap_pe=cap_pe, cap_mem=cap_mem)
    carry = runner.fresh_carry(d, ed, r=2, seed=0, cap_pe=cap_pe, cap_mem=cap_mem, alloc=True)
    assert int(carry.taboo.shape[1]) == table.n_moves  # the shipped tree holds
    narrowed = carry._replace(taboo=carry.taboo[:, :-1])
    msgs = C.check_chain_carry(ChainCarry._fields, int(narrowed.taboo.shape[1]),
                               table.n_moves, {}, cap_pe, {}, cap_mem)
    assert msgs and any("taboo-width" in m for m in msgs)


def test_real_dispatch_and_state_extractors_bind():
    src = _read(DEVEXP)
    assert len(C.dispatch_mv_names(src)) == 10
    state = C.state_tuple_fields(src)
    assert state is not None and len(state) == 20


SEEDED = {
    # name: (file, old, new, rule, files the finding must name)
    "scal-prefix-swap": (C.F_LAYOUT, '"area_mm2", "fitness",\n    "alp_time_s",',
                         '"area_mm2", "alp_time_s",\n    "fitness",', "scal-cols",
                         (C.F_LAYOUT, C.F_CUDA, C.F_KERNEL, C.F_OPS, C.F_BACKEND)),
    "cuda-n-scal": (C.F_CUDA, "constexpr int N_SCAL = 14;", "constexpr int N_SCAL = 13;",
                    "scal-cols", (C.F_LAYOUT, C.F_CUDA, C.F_KERNEL, C.F_OPS, C.F_BACKEND)),
    "cuda-rollup-reorder": (C.F_CUDA, "out[4] = fitness;\n    out[5] = acc_alp;",
                            "out[4] = acc_alp;\n    out[5] = fitness;", "scal-cols",
                            (C.F_LAYOUT, C.F_CUDA, C.F_KERNEL, C.F_OPS, C.F_BACKEND)),
    "taboo-narrowed": (C.F_DEVEXP, "taboo=np.zeros((r, m), np.int32)",
                       "taboo=np.zeros((r, m - 1), np.int32)", "chain-carry", (C.F_DEVEXP,)),
    "mv-dropped-from-valid": (
        C.F_DEVEXP,
        "            | (is_k[MV_ATT_MEM] & act_mem_a & (dest_r != c.mem_noc[:, a_mem]))\n", "",
        "move-codes", (C.F_DEVEXP,)),
    "device-menu-changed": (C.F_POLICY, 'device_menu = "telemetry"', 'device_menu = "farsi"',
                            "policy-registry", (C.F_POLICY, C.F_HEUR, C.F_DEVEXP)),
}


def _seeded_tree(tmp_path, name):
    """A copy of the port (and the docs it is held to) with one desync."""
    rel, old, new = SEEDED[name][:3]
    root = tmp_path / name
    shutil.copytree(PORT, root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "docs").mkdir()
    shutil.copy(os.path.join(REPO, "docs", "HEURISTICS.md"), root / "docs")
    path = root / rel
    src = path.read_text()
    assert old in src, (name, old)
    path.write_text(src.replace(old, new, 1))
    return str(root)


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_desync_on_disk_is_caught(tmp_path, name):
    rule, files = SEEDED[name][3:]
    port = lambda: {k: v for k, v in sys.modules.items() if k.split(".")[0] == "repro_torch"}
    before = port()
    findings = C.run_contracts(root=_seeded_tree(tmp_path, name))
    hits = [f for f in findings if f.rule == rule]
    assert hits, [f.render() for f in findings]
    assert all(f.rule == rule for f in findings), [f.render() for f in findings]
    for f in hits:
        rendered = f.render()
        assert all(p in rendered for p in files), rendered
    # the copy's modules are gone again, and this process's are back
    assert port() == before
    assert not C.run_contracts()


def _cli(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.path.join(cwd, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", ["scal-prefix-swap", "taboo-narrowed"])
def test_cli_strict_exits_one_on_a_seeded_tree(tmp_path, name):
    root = _seeded_tree(tmp_path, name)
    out = _cli("--strict", "--device", "cpu", cwd=root)
    assert out.returncode == 1, out.stdout + out.stderr
    for p in SEEDED[name][4]:
        assert p in out.stdout, out.stdout


def test_cli_strict_device_cpu_exits_zero_on_shipped_tree():
    out = _cli("--strict", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 live finding(s)" in out.stderr, out.stderr


def test_device_cuda_without_a_card_exits_two(monkeypatch, capsys):
    from repro_torch.analysis import DeviceUnavailable, run_all
    from repro_torch.analysis.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        run_all(device="cuda")
    assert main(["--strict"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_help_imports_neither_torch_nor_jax():
    code = (
        "import sys\n"
        "from repro_torch.analysis.__main__ import main\n"
        "try:\n"
        "    main(['--help'])\n"
        "except SystemExit:\n"
        "    pass\n"
        "print('torch' in sys.modules, 'jax' in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False False", out.stdout


def test_finding_key_survives_line_drift():
    f1 = Finding("lint", "host-sync", "m", "p.py", 10, source="x = float(y)")
    f2 = Finding("lint", "host-sync", "m", "p.py", 99, source="x = float(y)")
    assert f1.key() == f2.key()


# ---------------------------------------------------------------------------
# launch audit (on the CPU: the op log is the runtime check)
# ---------------------------------------------------------------------------
def test_launch_audit_clean_on_cpu():
    from repro_torch.analysis.launch_audit import CHAIN_K, run_launch_audit

    report = {}
    findings = run_launch_audit("cpu", report=report)
    assert not findings, "\n".join(f.render() for f in findings)
    for entry in ("phase_sim_plain", "chain_block", "ops.phase_sim"):
        assert report[entry]["ops"] > 0 and report[entry]["forbidden"] == 0, report
    assert report["chain_block"]["k"] == CHAIN_K
    assert report["chain_block"]["casts"] > 0  # dtype casts are allowed


def test_op_log_catches_item_injected_into_the_step(monkeypatch):
    from repro_torch.analysis.launch_audit import run_launch_audit
    from repro_torch.core import device_explore as dx

    class LeakyBlock(dx._ChainBlock):
        def _step(self, c, *args):
            c.fitness.sum().item()  # the host sync under test
            return super()._step(c, *args)

    monkeypatch.setattr(dx, "_ChainBlock", LeakyBlock)
    findings = run_launch_audit("cpu", entries=["chain_block"])
    assert [f.rule for f in findings] == ["forbidden-op"], [f.render() for f in findings]
    assert "_local_scalar_dense" in findings[0].message and "×8" in findings[0].message


def test_op_log_forbids_syncs_data_sized_ops_and_device_copies():
    from repro_torch.analysis.launch_audit import OpLog

    x = torch.arange(6.0)
    log = OpLog()
    with log:
        x.sum().item()
        bool(x.any())
        x.nonzero()
        torch.unique(x)
        torch.masked_select(x, x > 2)
        torch.bincount(x.long())
        x.to("meta")  # another device
        x.to(torch.float64).float()  # dtype casts: allowed
    reasons = set(log.bad)
    assert len([r for r in reasons if "_local_scalar_dense" in r]) == 1
    assert log.bad[next(r for r in reasons if "_local_scalar_dense" in r)] == 2
    assert {"nonzero", "masked_select", "bincount", "_to_copy cpu->meta"} <= reasons
    assert any("unique" in r for r in reasons)
    assert log.counts["_to_copy"] == 4 and sum(log.bad.values()) == 7  # .long() casts too


def test_bucket_grid_within_bound():
    from repro_torch.analysis.launch_audit import BUCKET_GRID_BOUND, audit_bucket_grid

    report = {}
    assert not audit_bucket_grid(report)
    assert report["bucket_grid"]["bucket"] == report["bucket_grid"]["buffer_key"] \
        == BUCKET_GRID_BOUND == 100


def test_bucket_grid_bound_trips_when_widened(monkeypatch):
    from repro_torch.analysis.launch_audit import audit_bucket_grid
    from repro_torch.core import backend

    monkeypatch.setattr(backend, "_bucket", lambda n: max(2, backend._pow2(n)))
    findings = audit_bucket_grid()
    assert {f.rule for f in findings} == {"buffer-key-bound"} and len(findings) == 2


# ---------------------------------------------------------------------------
# parity with the reference's analysis: bound values and pure checks
# ---------------------------------------------------------------------------
def test_bound_values_equal_the_reference():
    import numpy as np

    from repro.core import backend as ref_backend
    from repro.core import device_explore as ref_dx
    from repro.core import policy as ref_policy
    from repro.core import scal_layout as ref_layout
    from repro_torch.core import backend, device_explore, policy, scal_layout

    assert scal_layout.SCAL_COLS == ref_layout.SCAL_COLS
    assert device_explore.ChainCarry._fields == ref_dx.ChainCarry._fields
    assert C.move_codes(device_explore) == C.move_codes(ref_dx)
    assert list(device_explore.MENUS) == list(ref_dx.MENUS)
    assert np.array_equal(device_explore._KIND_PRECEDENCE, np.asarray(ref_dx._KIND_PRECEDENCE))
    assert C.state_tuple_fields(_read(DEVEXP)) == ref_contracts.state_tuple_fields(
        _read(os.path.join(REPO, "src", "repro", "core", "device_explore.py")))
    assert {n: c.device_menu for n, c in policy.POLICIES.items()} == \
        {n: c.device_menu for n, c in ref_policy.POLICIES.items()}
    grid = [(b, s, n) for b in range(1, 65) for s in range(1, 65) for n in (1, 2, 4, 8)]
    port_keys = {(backend._bucket(b), backend._bucket(s), n) for b, s, n in grid}
    ref_keys = {(ref_backend._bucket(b), ref_backend._bucket(s), n) for b, s, n in grid}
    assert port_keys == ref_keys and len(port_keys) == 100


_REF_ROLLUP = ref_contracts.kernel_rollup_sources(_read(os.path.join(
    REPO, "src", "repro", "kernels", "phase_sim", "kernel.py")))
_SWAP = list(_COLS)
_SWAP[4], _SWAP[5] = _SWAP[5], _SWAP[4]
_FIELDS = C.CARRY_PREFIX + ("pe_active", "accel")
_CODES = {"MV_MIG_PE": 0, "MV_MIG_MEM": 1, "MV_FORK_PE": 2, "MV_FORK_MEM": 3}
PURE_CASES = [
    ("check_scal_cols", (_COLS, _COLS, _COLS[:9], 14, 14)),
    ("check_scal_cols", (_COLS, tuple(_SWAP), _COLS[:9], 13, 12)),
    ("check_scal_cols", (_COLS, _COLS, _COLS[1:9], 14, None)),
    ("check_rollup_anchors", (_COLS, _REF_ROLLUP)),
    ("check_rollup_anchors", (tuple(_SWAP), _REF_ROLLUP)),
    ("check_rollup_anchors", (_COLS, _REF_ROLLUP[:-1])),
    ("check_chain_carry", (_FIELDS, 10, 10, {"pe_active": 4}, 4, {}, 4)),
    ("check_chain_carry", (_FIELDS, 9, 10, {"pe_active": 3}, 4, {"mem_bw": 5}, 4)),
    ("check_chain_carry", (("task_mem",) + _FIELDS[1:], 10, 10, {}, 4, {}, 4,
                           ("task_pe", "task_mem", "pe_active"))),
    ("check_move_codes", (_CODES, 4, list(_CODES))),
    ("check_move_codes", ({**_CODES, "MV_FORK_MEM": 5}, 3, ["MV_MIG_PE"])),
    ("check_move_codes", ({"MV_MIG_PE": 1, "MV_MIG_MEM": 0}, 2, ["MV_MIG_PE", "MV_MIG_MEM"])),
    ("check_policy_registry", ({"farsi": "farsi"}, ("farsi",), {"farsi": "farsi"}, ["farsi"])),
    ("check_policy_registry", ({"farsi": "bogus", "x": "farsi"}, ("farsi",),
                               {"farsi": "telemetry", "y": "farsi"}, ["farsi", "z"])),
]


@pytest.mark.parametrize("name,args", PURE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(PURE_CASES)])
def test_pure_checks_match_the_reference(name, args):
    """The same desynced inputs give the same number of findings."""
    kw = {"anchors": ref_contracts.ROLLUP_ANCHORS} if name == "check_rollup_anchors" else {}
    got = getattr(C, name)(*args, **kw)
    want = getattr(ref_contracts, name)(*args)
    assert len(got) == len(want), (got, want)


def test_contract_registries_match_the_reference():
    """The same four contracts, each clean on its own tree."""
    assert [c.name for c in C.CONTRACTS] == [c.name for c in ref_contracts.CONTRACTS]
    assert not ref_contracts.run_contracts() and not C.run_contracts()
