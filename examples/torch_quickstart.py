"""Quickstart on the PyTorch port: FARSI DSE on the AR workload complex.

Builds the Audio/CAVA/Edge-Detection task graphs, calibrates budgets, runs
the architecture-aware explorer from the 1-GPP base design — every
iteration's neighbours priced by one launch of the CUDA phase-sim kernel —
and prints the convergence trajectory + final SoC.

  PYTHONPATH=src python examples/torch_quickstart.py [--iterations 500] [--awareness farsi]
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # no card: the plain version
"""
import argparse

from repro_torch.core import (
    AWARENESS_LEVELS,
    Design,
    Explorer,
    ExplorerConfig,
    HardwareDatabase,
    ar_complex,
    calibrated_budget,
    simulate,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--awareness", choices=AWARENESS_LEVELS, default="farsi")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument(
        "--backend", choices=("python", "torch"), default="torch",
        help="simulation backend: scalar Python reference or the batched "
             "torch backend (each iteration's neighbour set in one dispatch)",
    )
    ap.add_argument("--device", default=None,
                    help="where the torch backend prices (default: the card; 'cpu' "
                         "runs the kernel's plain PyTorch version)")
    args = ap.parse_args()

    db = HardwareDatabase()
    graph = ar_complex()
    budget = calibrated_budget(db)
    print(f"workloads: {sorted(set(t.split('.')[0] for t in graph.tasks))}")
    print(f"latency budgets (ms): "
          f"{ {k: round(v*1e3,1) for k,v in budget.latency_s.items()} }")
    print(f"power budget: {budget.power_w*1e3:.0f} mW   area budget: {budget.area_mm2:.1f} mm²")

    base = Design.base(graph)
    r0 = simulate(base, graph, db)
    print(f"\nbase design (1 GPP + 1 NoC + 1 DRAM): latency={r0.latency_s:.2f}s "
          f"power={r0.power_w*1e3:.1f}mW area={r0.area_mm2:.1f}mm²")

    ex = Explorer(
        graph, db, budget,
        ExplorerConfig(awareness=args.awareness, max_iterations=args.iterations,
                       seed=args.seed, backend=args.backend,
                       device=args.device or "cuda"),
    )
    res = ex.run()

    stats = ex.backend.stats()
    print(f"\nexplored {res.n_sims} designs in {res.wall_s:.1f}s "
          f"({res.n_sims/max(res.wall_s,1e-9):.0f} sims/s) "
          f"[backend={res.backend_name}: {stats.n_dispatches} dispatches, "
          f"sim_wall={res.sim_wall_s:.1f}s]")
    print(f"converged={res.converged} after {res.iterations} iterations")
    for h in res.history[:: max(len(res.history) // 10, 1)]:
        print(f"  iter {h['iteration']:4d}  distance={h['distance']:10.3f}  "
              f"metric={h['metric']:8s} move={h['move']}")

    d, r = res.best_design, res.best_result
    print(f"\nfinal SoC: {d.block_counts()}  "
          f"latency/workload(ms)={ {k: round(v*1e3,1) for k,v in r.workload_latency_s.items()} }")
    print(f"power={r.power_w*1e3:.1f}mW area={r.area_mm2:.1f}mm²")
    print("co-design summary:", res.ledger.summary())


if __name__ == "__main__":
    main()
