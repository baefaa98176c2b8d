"""Randomized design sampling.

One generator shared by the simulator-equivalence tests, the backend
benchmarks, and anything seeding exploration populations — so every consumer
exercises the same design distribution: base design plus a random mix of
task-hardened accelerators and extra memories on a single NoC, random
buffer placement, random link count.
"""
from __future__ import annotations

import random
from typing import List

from .blocks import make_accelerator, make_mem
from .design import Design
from .tdg import TaskGraph


def random_single_noc_designs(
    g: TaskGraph, n: int, seed: int = 0, vary_links: bool = True
) -> List[Design]:
    """``n`` random single-NoC designs shaped like SA neighbourhoods."""
    rng = random.Random(seed)
    designs = []
    for _ in range(n):
        d = Design.base(g)
        noc = d.noc_chain[0]
        tasks = sorted(g.tasks)
        for _ in range(rng.randint(0, 6)):
            if rng.random() < 0.6:
                t = rng.choice(tasks)
                b = d.add_block(
                    make_accelerator(t, rng.choice((100, 400, 800))), attach_to=noc
                )
                b.unroll = rng.choice((1, 8, 64))
                d.task_pe[t] = b.name
            else:
                d.add_block(
                    make_mem(
                        rng.choice(("dram", "sram")),
                        rng.choice((100, 800)),
                        rng.choice((32, 256)),
                    ),
                    attach_to=noc,
                )
        mems = d.mems()
        for t in tasks:
            d.task_mem[t] = rng.choice(mems)
        if vary_links:
            d.blocks[noc].n_links = rng.choice((1, 2, 4))
        designs.append(d)
    return designs
