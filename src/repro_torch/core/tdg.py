"""Task dependency graphs (paper §2.3/§3.1).

A *task* is the smallest unit of simulation. Nodes carry the extended-Gables
software characteristics: work ``f`` (ops), operational intensities
``I_read``/``I_write`` (ops/byte — the paper splits I because modern routers
and memories have separate read/write channels), loop-level parallelism ``llp``
and burst size. Edges carry producer→consumer data movement in bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    work_ops: float  # f: task work in ops
    i_read: float  # ops per byte read
    i_write: float  # ops per byte written
    llp: float = 1.0  # avg independent loop iterations (loop-level parallelism)
    burst_bytes: float = 64.0  # communication burst size (NoC congestion model)

    @property
    def read_bytes(self) -> float:
        return self.work_ops / max(self.i_read, 1e-30)

    @property
    def write_bytes(self) -> float:
        return self.work_ops / max(self.i_write, 1e-30)

    @property
    def data_bytes(self) -> float:
        """D: total task data transferred (Table 2)."""
        return self.read_bytes + self.write_bytes


class TaskGraph:
    """A DAG of tasks for one workload."""

    def __init__(self, name: str):
        self.name = name
        self.tasks: Dict[str, Task] = {}
        self.parents: Dict[str, List[str]] = {}
        self.children: Dict[str, List[str]] = {}
        self.edge_bytes: Dict[Tuple[str, str], float] = {}
        self._par_cache: Dict[str, List[str]] = {}  # parallel_tasks_of memo
        self._par_set_cache: Dict[str, frozenset] = {}  # parallel_set_of memo

    def add_task(self, task: Task) -> Task:
        assert task.name not in self.tasks, task.name
        self.tasks[task.name] = task
        self.parents.setdefault(task.name, [])
        self.children.setdefault(task.name, [])
        self._par_cache.clear()
        self._par_set_cache.clear()
        return task

    def add_edge(self, src: str, dst: str, nbytes: float = 0.0) -> None:
        assert src in self.tasks and dst in self.tasks
        self.children[src].append(dst)
        self.parents[dst].append(src)
        self.edge_bytes[(src, dst)] = nbytes
        self._par_cache.clear()
        self._par_set_cache.clear()

    # ---- structural queries -------------------------------------------
    def roots(self) -> List[str]:
        return [t for t in self.tasks if not self.parents[t]]

    def topo_order(self) -> List[str]:
        order, seen = [], set()

        def visit(n: str) -> None:
            if n in seen:
                return
            seen.add(n)
            for p in self.parents[n]:
                visit(p)
            order.append(n)

        for n in self.tasks:
            visit(n)
        return order

    def validate(self) -> None:
        order = self.topo_order()
        assert len(order) == len(self.tasks)
        pos = {n: i for i, n in enumerate(order)}
        for (s, d) in self.edge_bytes:
            assert pos[s] < pos[d], f"cycle via {s}->{d}"

    # ---- Gables / domain-awareness metrics (Table 1, Fig. 12) ----------
    def avg_work_ops(self) -> float:
        return sum(t.work_ops for t in self.tasks.values()) / len(self.tasks)

    def avg_data_bytes(self) -> float:
        return sum(t.data_bytes for t in self.tasks.values()) / len(self.tasks)

    def avg_llp(self) -> float:
        return sum(t.llp for t in self.tasks.values()) / len(self.tasks)

    def ancestors(self, name: str) -> set:
        out, stack = set(), list(self.parents[name])
        while stack:
            n = stack.pop()
            if n not in out:
                out.add(n)
                stack.extend(self.parents[n])
        return out

    def concurrent_pairs(self) -> List[Tuple[str, str]]:
        """Task pairs with no ancestor/descendant relation (can run in parallel)."""
        names = list(self.tasks)
        anc = {n: self.ancestors(n) for n in names}
        pairs = []
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                if a not in anc[b] and b not in anc[a]:
                    pairs.append((a, b))
        return pairs

    def talp(self) -> float:
        """(Ta)sk-(L)evel (P)arallelism: number of concurrently runnable task
        combinations (paper counts combinations; we count concurrent pairs + 1
        so a pure chain scores 1, matching CAVA's TaLP=1)."""
        return float(len(self.concurrent_pairs()) + 1) if len(self.tasks) > 1 else 1.0

    def parallel_tasks_of(self, name: str) -> List[str]:
        # memoized: the explorer's Algorithm-1 move selection asks this every
        # iteration, and the O(T²) ancestor walks dominated its host time.
        # The cache clears on any graph edit (add_task/add_edge).
        hit = self._par_cache.get(name)
        if hit is None:
            anc = self.ancestors(name)
            desc = {n for n in self.tasks if name in self.ancestors(n)}
            hit = self._par_cache[name] = [
                n for n in self.tasks if n != name and n not in anc and n not in desc
            ]
        return hit

    def parallel_set_of(self, name: str) -> frozenset:
        """Frozenset view of :meth:`parallel_tasks_of` — the policy layer's
        co-residency checks are set intersections against hosted-task lists,
        and rebuilding a set from the memoized list on every Algorithm-1 move
        selection was the remaining per-iteration graph cost. Same cache
        discipline: cleared on any graph edit."""
        hit = self._par_set_cache.get(name)
        if hit is None:
            hit = self._par_set_cache[name] = frozenset(self.parallel_tasks_of(name))
        return hit


def merge_graphs(graphs: Iterable[TaskGraph], name: str = "combined") -> TaskGraph:
    """A multi-workload SoC runs all TDGs simultaneously (paper §5: 'an SoC
    that runs all three workloads together'). Tasks are namespaced."""
    out = TaskGraph(name)
    for g in graphs:
        for t in g.tasks.values():
            out.add_task(dataclasses.replace(t, name=f"{g.name}.{t.name}"))
        for (s, d), b in g.edge_bytes.items():
            out.add_edge(f"{g.name}.{s}", f"{g.name}.{d}", b)
    return out


def workload_of(task_name: str) -> str:
    """Inverse of the merge namespacing."""
    return task_name.split(".", 1)[0] if "." in task_name else task_name
