"""Regenerate tests/data/ref_dryrun_train_4k.json: the JAX package's own
compiled dry run of the ten ``train_4k × 16x16`` cells, per device, at one
layer cycle (``n_layers = cycle_len``) and at full depth.

The reference's CLI (``python -m repro.launch.dryrun``) fails under JAX 0.9:
``jax.make_mesh`` builds Explicit axes there, and the step's sharding
constraints then raise ``ShardingTypeError``. This script calls the same
``run_cell`` in-process with two substitutions and edits nothing of
``src/repro/``:

  * ``repro.launch.dryrun.make_production_mesh`` builds the same mesh with
    Auto axes (``axis_types=(AxisType.Auto,) * n``), which is what the
    partitioner saw when the reference was written;
  * ``repro.launch.dryrun.get_config`` returns the config cut to one cycle
    for the ``one_cycle`` records (the full config for ``full_depth``).

Each record keeps what XLA reports for the compiled step: ``memory``
(argument, output, temp, code and alias bytes), ``cost`` (flops, bytes
accessed) and ``collectives`` (``repro.roofline.hlo.collective_bytes`` of
the compiled HLO), beside the cell's ``n_layers``. The process needs 512
host devices, so the script runs itself in a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` set before JAX
starts (``repro.launch.dryrun`` sets the same flag on import).

Run me: ``PYTHONPATH=src python tests/gen_ref_dryrun.py`` (a few minutes on
8 cores; ``--arch A --depth one --print`` compiles one cell and prints its
record instead). ``tests/test_torch_layout*.py`` hold the port's dry run to
this file, and ``tests/test_torch_layout.py`` recompiles the Qwen3-1.7B
one-cycle cell live and finds the file's integers equal. No JAX import
happens in the port or in ``chip_smoke.py``, which read the JSON only.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

from repro.configs.registry import arch_names  # no JAX import: XLA_FLAGS stays settable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "ref_dryrun_train_4k.json")
DEPTHS = {"one": "one_cycle", "full": "full_depth"}
FLAG = "--xla_force_host_platform_device_count=512"


def compile_cell(arch: str, depth: str) -> dict:
    """The reference's compiled record of ``arch × train_4k × 16x16`` at
    ``depth`` ("one" or "full"). Must run in a process whose JAX was
    started with :data:`FLAG`."""
    import jax
    from jax.sharding import AxisType

    import repro.launch.dryrun as RD

    def make_production_mesh(*, multi_pod: bool = False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

    full = RD.get_config(arch)
    cfg = full if depth == "full" else dataclasses.replace(full, n_layers=full.cycle_len)
    RD.make_production_mesh = make_production_mesh
    get_config, RD.get_config = RD.get_config, lambda name: cfg
    try:
        rec = RD.run_cell(arch, "train_4k", False, verbose=False)
    finally:
        RD.get_config = get_config
    if not rec["ok"]:
        raise RuntimeError(f"{arch} × train_4k ({depth}): {rec.get('error')}\n{rec.get('traceback')}")
    return {"n_layers": cfg.n_layers, "memory": rec["memory"], "cost": rec["cost"],
            "collectives": rec["collectives"]}


def run_child(args) -> str:
    """This script in a child process with 512 host devices; its stdout."""
    env = dict(os.environ, XLA_FLAGS=FLAG, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"] + args, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", help="one arch (repeatable); all ten by default")
    ap.add_argument("--depth", choices=("one", "full", "both"), default="both")
    ap.add_argument("--print", action="store_true", help="print the records, write no file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    archs = args.arch or arch_names()
    depths = ("one", "full") if args.depth == "both" else (args.depth,)
    if args.child:
        for arch in archs:
            for depth in depths:
                print(json.dumps({"arch": arch, "depth": DEPTHS[depth], **compile_cell(arch, depth)}),
                      flush=True)
        return
    lines = run_child([a for arch in archs for a in ("--arch", arch)] + ["--depth", args.depth])
    recs = [json.loads(ln) for ln in lines.splitlines() if ln.startswith("{")]
    if args.print:
        for r in recs:
            print(json.dumps(r))
        return
    import jax

    out = {"source": "tests/gen_ref_dryrun.py: repro.launch.dryrun.run_cell, Auto-axis 16x16 mesh of 512 "
                     "host devices", "jax": jax.__version__, "shape": "train_4k", "mesh": "16x16",
           "one_cycle": {}, "full_depth": {}}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as f:
            old = json.load(f)
        out["one_cycle"].update(old.get("one_cycle", {}))
        out["full_depth"].update(old.get("full_depth", {}))
    for r in recs:
        out[r.pop("depth")][r.pop("arch")] = r
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(recs)} records to {os.path.relpath(FIXTURE, ROOT)}")


if __name__ == "__main__":
    main()
