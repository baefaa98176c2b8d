"""End-to-end training driver on the PyTorch port: synthetic data → train
state → train step (remat + grad accumulation) → checkpoints + supervisor
(fault-tolerant) → loss curve.

Attention and every RMSNorm run through the port's CUDA flash-attention
and RMSNorm kernels under autograd (``--device cpu`` runs their plain
PyTorch versions). Presets scale from CPU-friendly to the 100M-parameter
run:

  PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 40 --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
"""
import argparse
import os
import tempfile
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import for_model
from repro_torch.models.model import RunFlags
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.health import Supervisor
from repro_torch.train.step import init_train_state, make_train_step

PRESETS = {
    "tiny": dict(n_layers=2, d_model=64, d_ff=256, n_heads=4, n_kv_heads=2, vocab=512,
                 batch=4, seq=64),
    "2m": dict(n_layers=4, d_model=128, d_ff=512, n_heads=4, n_kv_heads=2, vocab=2048,
               batch=8, seq=128),
    "20m": dict(n_layers=8, d_model=256, d_ff=1024, n_heads=8, n_kv_heads=4, vocab=8192,
                batch=8, seq=256),
    "100m": dict(n_layers=12, d_model=768, d_ff=2048, n_heads=12, n_kv_heads=4, vocab=32768,
                 batch=32, seq=512),
}


def make_config(p) -> ModelConfig:
    return ModelConfig(
        name="train-lm",
        n_layers=p["n_layers"],
        d_model=p["d_model"],
        vocab_size=p["vocab"],
        n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"],
        head_dim=p["d_model"] // p["n_heads"],
        d_ff=p["d_ff"],
        rope_kind="rope",
        tie_embeddings=True,
        block_kinds=("attn",),
        mlp_kinds=("dense",),
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="2m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="where to train (default: the card)")
    args = ap.parse_args()

    p = PRESETS[args.preset]
    cfg = make_config(p)
    n_params = cfg.param_counts()["total"]
    flags = RunFlags(attn_impl="kernel", norm_impl="kernel")
    state = init_train_state(cfg, seed=0, device=args.device)
    print(f"preset={args.preset}: {n_params/1e6:.1f}M params, "
          f"{p['batch']}×{p['seq']} tokens/step, device={state['params'].device}")

    data = for_model(cfg, seq_len=p["seq"], global_batch=p["batch"], seed=0)
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, flags, opt, microbatches=args.microbatches)

    ckpt = CheckpointManager(args.ckpt_dir, keep_n=2, async_save=True)
    sup = Supervisor(ckpt, data, save_every=args.save_every)
    losses = []
    t0 = time.perf_counter()

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 10 == 0 or step == 1:
            dt = time.perf_counter() - t0
            tps = step * p["batch"] * p["seq"] / dt
            print(f"step {step:4d}  loss={losses[-1]:.4f}  lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f}  {tps:,.0f} tok/s")

    target = state
    sup.run(state, step_fn, args.steps, restore_fn=lambda: ckpt.restore(target),
            on_metrics=on_metrics)
    print(f"\nfinal: loss {losses[0]:.3f} → {losses[-1]:.3f} over {args.steps} steps "
          f"({time.perf_counter()-t0:.0f}s); stragglers flagged: {len(sup.monitor.flagged)}")
    assert losses[-1] < losses[0], "loss must decrease"


if __name__ == "__main__":
    main()
