"""Training launcher: train state → train step (remat + grad accumulation)
→ data pipeline → checkpoints + supervisor; the torch counterpart of
``repro.launch.train``, on one device (no mesh: sharding is later work).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --device cpu --steps 6 --seq-len 32 --global-batch 4

The device is the card unless ``--device`` names another. ``--attn-impl
kernel`` and ``--norm-impl kernel`` send attention and every RMSNorm
through the port's CUDA kernels (their plain versions on the CPU).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from ..checkpoint.manager import CheckpointManager
from ..configs.registry import arch_names, get_config, reduced_config
from ..data.pipeline import for_model
from ..models.model import RunFlags, resolve_device
from ..optim.adamw import AdamWConfig
from ..runtime.health import Supervisor
from ..train.step import init_train_state, make_train_step


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Parse ``argv`` (the command line when None), train, and return
    {"losses", "recoveries", "stragglers", "wall_s"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=arch_names(), default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--attn-impl", choices=("auto", "full", "blockwise", "kernel"), default="auto")
    ap.add_argument("--norm-impl", choices=("reference", "kernel"), default="reference")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    flags = RunFlags(attn_impl=args.attn_impl, norm_impl=args.norm_impl,
                     remat="none" if args.reduced else "full")
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=10, total_steps=args.steps)
    state = init_train_state(cfg, seed=0, device=device)
    step_fn = make_train_step(cfg, flags, opt, microbatches=args.microbatches)

    data = for_model(cfg, seq_len=args.seq_len, global_batch=args.global_batch, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir, keep_n=3, async_save=True)
    if args.resume and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state)
        data.skip_to(meta["extra"].get("data_step", meta["step"]))
        print(f"resumed from step {meta['step']}")

    sup = Supervisor(ckpt, data, save_every=args.save_every)
    losses: List[float] = []
    t0 = time.perf_counter()

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 10 == 0 or step == 1:
            print(f"step {step:4d}  loss={losses[-1]:.4f}  "
                  f"lr={float(m['lr']):.2e}  gnorm={float(m['grad_norm']):.2f}")

    target = state
    state = sup.run(state, step_fn, args.steps, restore_fn=lambda: ckpt.restore(target),
                    on_metrics=on_metrics)
    wall = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {wall:.1f}s on {device}; "
          f"stragglers={len(sup.monitor.flagged)}")
    return {"losses": losses, "recoveries": sup.recoveries,
            "stragglers": len(sup.monitor.flagged), "wall_s": wall}


if __name__ == "__main__":
    main()
