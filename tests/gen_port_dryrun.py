"""Write the port's own dry-run numbers of each arch cut to one layer cycle
at full width, on the ``16x16`` mesh: ``train_4k`` and, where the arch
serves them, ``prefill_32k`` and ``decode_32k``. For each cell:
``argument_bytes``, ``temp_bytes``, ``flops`` and ``collective_bytes``
(the total).

The port's layout is held to two such files (``launch.dryrun.layout_bars``
for the train cells, ``tests/test_torch_layout*.py``, ``chip_smoke.py``'s
``dryrun`` phase):

  * ``tests/data/port_dryrun_before.json``: the tree before the sharded
    step followed the reference's layout (commit 37e292d): no cell may hold
    more temp bytes, and no train cell send more collective bytes;
  * ``tests/data/port_dryrun_after.json``: the tree that made it follow,
    whose collective bytes a cell may exceed by half at most.

The script runs whichever port its ``PYTHONPATH`` names, under the fake
process group at world 256 on a ``"cuda"``-typed mesh of meta tensors (no
card, no JAX):

  PYTHONPATH=src python tests/gen_port_dryrun.py --out tests/data/port_dryrun_after.json \\
      --source "the port at commit ..."

(about eight minutes on 8 cores).
"""
import argparse
import dataclasses
import json

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import arch_names, get_config
from repro_torch.launch import dryrun as D

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")


def cell(arch: str, shape_name: str) -> dict:
    """The four numbers of ``arch`` cut to one cycle × ``shape_name`` × 16x16."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.cycle_len)
    with D.fake_world(256):
        rec = D.run_cell(cfg, shape_name, False, verbose=False)
    if not rec["ok"]:
        raise RuntimeError(f"{arch} × {shape_name}: {rec['traceback']}")
    return {"argument_bytes": rec["memory"]["argument_bytes"], "temp_bytes": rec["memory"]["temp_bytes"],
            "flops": rec["cost"]["flops"], "collective_bytes": rec["collectives"]["total"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--source", required=True, help="which tree the numbers are of")
    args = ap.parse_args(argv)
    out = {"source": args.source + "; tests/gen_port_dryrun.py: each arch cut to one layer cycle, 16x16 "
                                   "'cuda'-typed mesh under the fake process group at world 256, meta tensors",
           "mesh": "16x16"}
    for shape_name in SHAPE_NAMES:
        archs = [a for a in arch_names() if D.shape_applicable(get_config(a), SHAPES[shape_name])]
        out[shape_name] = {a: cell(a, shape_name) for a in archs}
        print(f"[gen_port_dryrun] {shape_name}: {len(archs)} cells", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
