"""Training launcher: (process group → mesh → placed state) → train step
(remat + grad accumulation) under the logical sharding rules → data
pipeline → checkpoints + supervisor; the torch counterpart of
``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --device cpu --steps 6 --seq-len 32 --global-batch 4

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --device cpu --reduced --model-axis 2

The first runs on one device with plain tensors. The second trains on a
(world / 2, 2) ("data", "model") mesh of four processes (gloo on the CPU,
NCCL on cards): the state is placed by ``runtime.elastic.state_shardings``
and every step runs under ``sharding.act.activation_rules``; every rank
feeds the same global batch, and only rank 0 prints. ``--model-axis 1``
at a world of 1 runs the same mesh path on a (1, 1) mesh of one device.

The device is the card unless ``--device`` names another. ``--attn-impl
kernel`` and ``--norm-impl kernel`` send attention and every RMSNorm
through the port's CUDA kernels (their plain versions on the CPU).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ShapeConfig
from ..configs.registry import arch_names, get_config, reduced_config
from ..data.pipeline import for_model
from ..models.model import RunFlags, resolve_device
from ..optim.adamw import AdamWConfig
from ..runtime.elastic import reshard_state, state_shardings
from ..runtime.health import Supervisor
from ..sharding.act import activation_rules
from ..sharding.rules import default_rules
from ..train.step import init_train_state, make_train_step
from .mesh import init_process_group, make_host_mesh

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    ap.add_argument("--model-axis", type=int, default=None,
                    help="train on a (world / N, N) mesh (default: a mesh only under a world > 1, N = 1)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--attn-impl", choices=("auto", "full", "blockwise", "kernel"), default="auto")
    ap.add_argument("--norm-impl", choices=("reference", "kernel"), default="reference")
    ap.add_argument("--compute-dtype", choices=tuple(DTYPES), default="bfloat16",
                    help="the forward's dtype (float32 for parity runs)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    meshed = args.model_axis is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1
    started = meshed and not dist.is_initialized()
    if meshed:
        init_process_group(device.type)
    try:
        return _train(args, device, meshed)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, device: torch.device, meshed: bool) -> Dict[str, object]:
    say = print if not meshed or dist.get_rank() == 0 else (lambda *a, **k: None)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    flags = RunFlags(attn_impl=args.attn_impl, norm_impl=args.norm_impl,
                     remat="none" if args.reduced else "full")
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=10, total_steps=args.steps)
    state = init_train_state(cfg, seed=0, device=device)
    shardings, rules_ctx, where = None, contextlib.nullcontext(), str(device)
    if meshed:
        mesh = make_host_mesh(args.model_axis or 1, device.type)
        shape = ShapeConfig("train", args.seq_len, args.global_batch, "train")
        rules = default_rules(cfg, shape, mesh)
        shardings = state_shardings(cfg, shape, mesh, state, rules)
        state = reshard_state(state, shardings)
        rules_ctx, where = activation_rules(rules, mesh), f"a {tuple(mesh.shape)} mesh of {device.type}"
    step_fn = make_train_step(cfg, flags, opt, microbatches=args.microbatches,
                              compute_dtype=DTYPES[args.compute_dtype])

    losses: List[float] = []
    with rules_ctx:
        data = for_model(cfg, seq_len=args.seq_len, global_batch=args.global_batch, seed=0)
        ckpt = CheckpointManager(args.ckpt_dir, keep_n=3, async_save=True)
        if args.resume and ckpt.latest_step() is not None:
            state, meta = ckpt.restore(state, shardings=shardings)
            data.skip_to(meta["extra"].get("data_step", meta["step"]))
            say(f"resumed from step {meta['step']}")

        sup = Supervisor(ckpt, data, save_every=args.save_every)
        t0 = time.perf_counter()

        def on_metrics(step, m):
            losses.append(float(m["loss"]))
            if step % 10 == 0 or step == 1:
                say(f"step {step:4d}  loss={losses[-1]:.4f}  "
                    f"lr={float(m['lr']):.2e}  gnorm={float(m['grad_norm']):.2f}")

        target = state
        state = sup.run(state, step_fn, args.steps,
                        restore_fn=lambda: ckpt.restore(target, shardings=shardings),
                        on_metrics=on_metrics)
        wall = time.perf_counter() - t0
    say(f"done: {args.steps} steps in {wall:.1f}s on {where}; "
        f"stragglers={len(sup.monitor.flagged)}")
    say("losses " + json.dumps(losses))
    return {"losses": losses, "recoveries": sup.recoveries,
            "stragglers": len(sup.monitor.flagged), "wall_s": wall}


if __name__ == "__main__":
    main()
