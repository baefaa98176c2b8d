"""Continuous-batching DSE serving: N concurrent exploration sessions, one
shared device batch stream, one content-addressed evaluation cache.

The PyTorch port's serve layer: every shared dispatch launches the CUDA
phase-sim kernel on the card (``--device cpu`` runs its plain PyTorch
version). Spins up a `DseService`, admits a mix of tenants — different workloads,
policies, and seeds, including replicas of the same request (the repeated-
scenario case the cache exists for) — staggers some arrivals mid-flight,
streams best-design-so-far events as they commit, and reports per-session
winners plus the fleet cache hit-rate.

  PYTHONPATH=src python examples/torch_serve_batch.py [--sessions 12] [--iterations 60] [--device cpu]
"""
import argparse
import time

from repro_torch.core import (
    ExplorerConfig,
    HardwareDatabase,
    ar_complex,
    audio,
    calibrated_budget,
)
from repro_torch.serve import DseService


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=12,
                    help="total sessions (half admitted up front, half join "
                         "mid-flight)")
    ap.add_argument("--iterations", type=int, default=60)
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the content-addressed DesignStore")
    ap.add_argument("--device", default=None,
                    help="where the sessions price (default: the card)")
    args = ap.parse_args()

    db = HardwareDatabase()
    budget = calibrated_budget(db)
    graphs = {"audio": audio(), "ar": ar_complex()}
    policies = ("farsi", "bottleneck", "naive_sa")

    svc = DseService(db, cache=not args.no_cache, device=args.device)
    svc_t0 = time.perf_counter()

    def on_event(ev):
        print(f"  [{time.perf_counter() - svc_t0:6.2f}s] {ev.session:<14s} "
              f"iter {ev.iteration:3d}  distance={ev.distance:8.3f}  "
              f"move={ev.move}" + ("  CONVERGED" if ev.converged else ""))

    def submit(i):
        wl = "audio" if i % 2 == 0 else "ar"
        pol = policies[i % len(policies)]
        # seeds repeat every 4 sessions per (workload, policy) mix — replica
        # requests are what the content-addressed cache collapses
        cfg = ExplorerConfig(policy=pol, seed=(i // 2) % 4,
                             max_iterations=args.iterations)
        return svc.submit(f"{wl}.{pol}.{i}", graphs[wl], budget, cfg,
                          on_event=on_event)

    n_head = max(args.sessions // 2, 1)
    handles = [submit(i) for i in range(n_head)]
    print(f"admitted {n_head} sessions up front; "
          f"{args.sessions - n_head} will join mid-flight\n")

    # drive a few ticks, then let latecomers join the live batch stream —
    # the continuous-batching case a lockstep Campaign cannot express
    for _ in range(5):
        svc.step()
    for i in range(n_head, args.sessions):
        handles.append(submit(i))
    stats = svc.run()

    print(f"\n== {stats.n_done}/{stats.n_sessions} sessions done in "
          f"{stats.n_ticks} ticks, {stats.wall_s:.2f}s "
          f"({stats.evals_per_s:,.0f} evals/s aggregate) ==")
    for h in handles:
        r = h.result
        print(f"  {h.name:<16s} iters={r.iterations:3d} "
              f"converged={str(r.converged):<5s} "
              f"distance={r.best_distance.city_block():8.3f}  "
              f"blocks={r.best_design.block_counts()}  "
              f"latency={h.latency_s:.2f}s  events={len(h.events)}")
    print(f"\ncache: hits={stats.cache_hits} misses={stats.cache_misses} "
          f"bypass={stats.cache_bypasses} evictions={stats.cache_evictions} "
          f"hit-rate={stats.cache_hit_rate:.1%}")
    print(f"session latency: p50={stats.latency_percentile(50):.2f}s "
          f"p95={stats.latency_percentile(95):.2f}s; "
          f"fallback evals: {stats.n_fallback}")


if __name__ == "__main__":
    main()
