"""Fault-tolerance demo on the PyTorch port: inject a step failure
mid-training; the supervisor restores the last atomic checkpoint, rewinds
the data pipeline, and the run completes with the SAME final parameters as
an uninterrupted run (bit for bit: the replayed steps repeat the same
arithmetic, under ``torch.use_deterministic_algorithms``).

Attention and every RMSNorm run through the port's CUDA kernels under
autograd (``--device cpu``: their plain PyTorch versions).

  PYTHONPATH=src python examples/torch_fault_tolerance.py [--device cpu]
"""
import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import reduced_config
from repro_torch.data.pipeline import for_model
from repro_torch.models.model import RunFlags
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.health import Supervisor
from repro_torch.train.step import init_train_state, make_train_step

STEPS, SAVE_EVERY, FAIL_AT = 24, 6, 15


def run(workdir: str, inject_failure: bool, flags: RunFlags, device):
    cfg = reduced_config("qwen3-1.7b")
    data = for_model(cfg, seq_len=32, global_batch=4, seed=0)
    state = init_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, flags, AdamWConfig(peak_lr=1e-3, warmup_steps=2))
    calls = {"n": 0}

    def maybe_flaky(s, b):
        calls["n"] += 1
        if inject_failure and calls["n"] == FAIL_AT:
            print("  !! injected device failure at call", calls["n"])
            raise RuntimeError("simulated device failure")
        return step(s, b)

    ckpt = CheckpointManager(workdir, keep_n=3, async_save=False)
    sup = Supervisor(ckpt, data, save_every=SAVE_EVERY)
    target = state
    out = sup.run(state, maybe_flaky, STEPS,
                  restore_fn=lambda: ckpt.restore(target),
                  on_metrics=lambda s, m: print(f"  step {s:3d} loss={float(m['loss']):.4f}")
                  if s % 6 == 0 else None)
    return out, sup.recoveries


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="where to train (default: the card)")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before the first cuBLAS handle
    torch.use_deterministic_algorithms(True)
    flags = RunFlags(attn_impl="kernel", norm_impl="kernel")
    d1, d2 = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        print("reference run (no failure):")
        ref, _ = run(d1, False, flags, args.device)
        print(f"\nfaulty run (failure at call {FAIL_AT} → restore from step 12):")
        out, recoveries = run(d2, True, flags, args.device)
        same = all(torch.equal(a, b) for a, b in zip(ref["params"].parameters(), out["params"].parameters()))
        print(f"\nrecoveries={recoveries}; final params identical to uninterrupted run: {same}")
        assert same and recoveries == 1
    finally:
        shutil.rmtree(d1, ignore_errors=True)
        shutil.rmtree(d2, ignore_errors=True)


if __name__ == "__main__":
    main()
