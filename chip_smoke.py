#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Drives the port's paths and checks them: FARSI's price-and-search loop,
``Explorer.run()`` on the AR workload complex, through the CUDA phase-sim
kernel; the device chain block (``Explorer.run_chains()``), whose every
iteration prices R chains through the same kernel; serving Qwen3-1.7B at
full width and depth (``generate``: prefill and greedy decode) through the
CUDA flash-attention kernel; serving Mamba2-370m at full width and depth
through the CUDA SSD and RMSNorm kernels; serving the MoE stacks at full
width (Jamba, one whole 8-layer cycle, through all three LLM kernels, and
four layers of Qwen3-MoE); training Qwen3-1.7B at full width and depth
with the flash and RMSNorm kernels in the forward pass under autograd;
training one full-width layer of Qwen3-MoE the same way; and the sharded
training path (DTensor state, activation constraints, the shard_map MoE
over NCCL all-to-alls) on a (1, 1) mesh of the one card.
Phases, each printing one JSON line:

  1. env       card name and power limit, torch / CUDA versions
  2. build     nvcc build of the kernel (registers, shared memory, spills)
  3. parity    kernel vs its plain PyTorch version on the card, every output
               column, ≤ 1e-5 relative, codes, phase counts and argmaxes
               exact (audio, ar_complex and a > 32-task synthetic graph at
               1–3 NoCs; synthetic graphs of 1, 28, 31, 32, 33, 64, 257 and
               1024 tasks at 1, 2 and 8 NoCs; B ∈ {1, 4, 256, 4096}, fewer
               at 257 and 1024 tasks; random DAGs of 40, 64 and 100 tasks,
               seeds 0-2, 16 designs each, with the worst error per column)
  4. timing    kernel and plain-version times (CUDA events) beside the bound
  5. main_path Explorer.run() on ar_complex, farsi, seed 1, 500 iterations;
               the kernel's launch count is zeroed just before and read just
               after, and the best design is re-priced by the scalar simulator
  6. golden    two recorded accepted-move sequences replayed on the card
  6a. chain    the device chain block (DeviceChainRunner.run_chains) on
               ar_complex, farsi menu, alloc on, K = 32, through the
               phase-sim kernel: R = 1, 16, 256, wall per block
               (synchronised, median of 3) and chain steps/s; exactly K
               kernel launches a block; the K iterations run under
               torch.cuda.set_sync_debug_mode("error"); the fused R = 1
               block equals run_chains_host bit for bit, chains 0, 5, 15
               at R = 16 equal those at R = 256; an R = 4, K = 16 block on
               the card samples the sequences the CPU path samples; device
               kernels per step and busy share of an R = 16 block (profiler),
               host µs and kernels of a step's three threefry draws
  6b. chain_explore  Explorer.run_chains() on ar_complex, chain_r 16,
               chain_k 32, chain_alloc, 512 iterations: wall, chain steps/s,
               dispatches, cached blocks, kernel launches (one per
               iteration plus the winner's decode), beside main_path's
               sims/s; the best design re-priced by the scalar simulator
  6c. analysis the port's analysis gate, run_all(device="cuda") of
               repro_torch.analysis: the layout contracts (the scal columns
               against the CUDA source, the chain carry, the move codes, the
               policy registry), the torch lint of the hot scopes, and the
               launch audit (phase_sim_plain, an R = 4, K = 8 chain block and
               ops.phase_sim under an op log; the block exactly K launches,
               its K iterations under sync-debug "error", no synchronisation
               or device-to-host copy in its profiled window, the kernel's
               symbol in the trace; the wrapper exactly 1 launch; the bucket
               grid's 100 keys): live findings per pass (any fails the run),
               the key counts, the launches (zeroed just before, read just
               after), and the seconds
  6d. serve_dse  DseService on the card with a DesignStore, ar_complex,
               calibrated budget: the reference's repeated scenario, 64
               sessions (16 replicas × farsi, naive_sa, bottleneck,
               locality; seed rep % 4; 60 iterations),
               32 up front and 32 joining after 5 ticks, and 2 chain-batched
               sessions (chain_r 16, chain_k 32, chain_alloc): ticks, wall,
               evals/s, p50/p95 session latency, cache counters and hit rate
               (> 0.3), rows per shared dispatch; phase-sim launches (zeroed
               just before, read just after) equal to the dispatches that
               reached the kernel (candidate dispatches that sent a row to
               the card, plus K per chain block, counted apart); no failure,
               dispatch fault, degradation, fallback or non-finite row;
               replicas bit for bit; three sessions re-run alone on a fresh
               service bit for bit; every best design re-priced by the
               scalar simulator within 1e-5; the device's busy share of the
               same run under the profiler; then the same 64 host-loop
               sessions with 64 distinct seeds (no repeats, no chain
               session), with the same numbers and checks bar the replicas
  6e. serve_chaos  8 sessions under FaultInjector(seed=7) at the reference
               chaos sweep's combined rates, twice: identical schedules,
               counters and results; the sessions the injector never touched
               equal a fault-free run bit for bit; nothing escapes run();
               a phase-sim launch made to raise fails its session with
               DispatchFailed, nothing degraded to the CPU fallback
  6f. campaign Campaign on audio and ar_complex, seeds 0-1, farsi, naive_sa
               and bottleneck, 60 iterations, with and without the
               DesignStore: runs identical; wall, dispatches, launches, cache
  7. flash_build   nvcc build of the flash kernel (started in parallel with
                   the phase-sim build; registers, shared memory, spills)
  8. flash_parity  flash kernel vs its plain version on the card: bf16 and
                   f32, Dh 16-256, MHA/GQA/MQA, causal and not, S 128-2048
                   and a ragged S, and serve's layout (B=4, H=16, KH=8,
                   Dh=128); on the tensor-core route also Dh 64 and 256 at
                   serve's layout, GQA 16:1, and q, k, v sliced from one
                   fused projection through ops.flash_attention (bf16 and,
                   on the CUDA-core route, f32); each case checks the route
                   its dtype and Dh pick; <= 2e-2 (bf16) / 2e-5 (f32), the
                   reference's own bars
  9. flash_timing  kernel, ops.flash_attention on (B, S, H, Dh) inputs,
                   plain-version and SDPA times beside the bound and its
                   share at the Qwen3-1.7B prefill shape (B=4, S=512) and at
                   S=2048, the kernel first held to its plain version
 10. serve     generate() on Qwen3-1.7B, 28 layers, seeded random bf16
               weights made on the card: 4 prompts of 512 tokens, 32 new
               tokens each, attn_impl="kernel"; the flash launch count is
               zeroed just before and read just after (must be 28, all on
               the tensor-core route); prefill
               timed as generate() with 0 new tokens; then the plain
               attention path on the same weights (2 layers: held to the
               reference's bar; 28 layers: reported)
 11. ssd_build, rmsnorm_build   nvcc builds of the SSD and RMSNorm kernels
               (started in parallel with the other two builds)
 12. ssd_parity    one wgmma tile of each tensor-core product against
                   torch.matmul first; then the SSD kernel vs its plain
                   version on the card, y and the final state:
                   tests/test_kernels.py's SSD_CASES, the serving shape (B=4,
                   S=512, H=32, P=64, N=128) in bf16 and f32 at chunk 64 and
                   128, S=2048, and chunk = P = N = 128 in f32 and with x
                   and B/C of different dtypes (the CUDA-core route, its head
                   dim split over two blocks) (contiguous, through ssd_cuda);
                   and ops.ssd on x, B and C sliced from one projection at
                   chunk, P and N in {64, 128}, S from one chunk to 2048, bf16
                   and f32; each case reports the route it took and fails on
                   another than kernel.route names; y <= 5e-2 (bf16) / 1e-3
                   (f32), h <= 1e-3, the reference's own bars; then CUDA-core
                   instances that fit whole, run with the head dim split
                   across blocks: equal to the whole instance bit for bit
 13. rmsnorm_parity  RMSNorm kernel vs its plain version: test_kernels.py's
                   shapes, (2048, 1024), (2048, 2048), (4, 1024), (4, 2048),
                   a ragged (1000, 1024), an odd (33, 1001), qk-norm's
                   (32768, 128), (16, 8192), (4, 12288), train_moe's
                   d_model rows (4096, 4096), and x one element past
                   16-byte alignment; f32, bf16, bf16 with an f32
                   weight; <= 1e-5 (f32) / 2e-2 (bf16)
 14. ssd_timing    kernel (ssd_cuda), ops.ssd and plain-version times beside
                   the bound at the serving shape (bf16, chunk 64) and at
                   S=2048, on the model's layout (x, B, C slices of one
                   projection), the kernel first held to its plain version
                   on those inputs
 15. rmsnorm_timing  kernel, plain-version and F.rms_norm times beside the
                   bound at the serving shapes, and the host microseconds of
                   one ops.rmsnorm, rmsnorm_cuda and F.rms_norm call (at
                   (4, 1024) also of the launch's parts)
 16. serve_mamba   generate() on Mamba2-370m, 48 layers, seeded random bf16
               weights made on the card: 4 prompts of 512 tokens, 32 new
               tokens each, ssd_impl="kernel", norm_impl="kernel"; the launch
               counts are zeroed just before and read just after (must be
               48 SSD, one per layer in the prefill, all on the tensor-core
               route, and 97 x 33 = 3,201
               RMSNorm: norm1 and the gated norm of each layer plus the final
               norm, in the prefill and in each of the 32 decode calls);
               timed as serve is; then the plain path on the same weights (2
               layers: held to the reference's bar; 48 layers: reported)
 16b. serve_moe  generate() on Jamba (jamba-v0.1-52b cut from 32 to 8
               layers: one whole cycle, 1 attention and 7 Mamba-2 layers, 4
               MoE layers of 16 experts top-2 and 4 dense ones; 13.27 B
               parameters) and on Qwen3-MoE (cut from 94 to 4 layers, 128
               experts top-8, qk-norm; 11.2 B), full width, seeded random
               bf16 weights made on the card, one model at a time (freed
               before the next phase): the memory allocated before each;
               one MoE layer at the prefill and the decode shape under
               torch.cuda.set_sync_debug_mode("error"); 4 prompts of 512
               tokens, 32 new tokens, attn_impl, ssd_impl and norm_impl
               "kernel", timed as serve is (tokens/s, prefill ms, decode ms
               a step beside its bound: every weight read once, the caches
               once, over 3.35 TB/s); launches counted (zeroed just before,
               read just after) and held to moe_want_launches (Jamba 1
               flash, 7 SSD, 792 RMSNorm; Qwen3-MoE 4 flash, 561 RMSNorm),
               flash and SSD all on tensor cores; then the kernel path
               against the plain path on the same weights: each layer alone
               from the plain path's hidden state (the reference's bar on
               the layer's output for the tokens routed alike; the share of
               tokens with another top-k expert set at each MoE layer, with
               the router's margin at the top-k boundary: at most 5 % for
               Jamba, reported for Qwen3-MoE), then end to end (flips
               compound with depth: Jamba's first 4 layers held, flips per
               MoE layer at most 5 % and the bar on every position whose
               causal context was routed alike in every MoE layer; Jamba's 8
               and Qwen3-MoE's 4 layers reported)
 17. flash_grad  ops.flash_attention under autograd (the kernel's forward
               with the row lse, the plain flash backward) against
               flash_ref.FlashAttentionRef (plain forward and backward) on
               the card: out at FLASH_TOL, lse within 1e-5 and dq, dk, dv
               within FLASH_TOL of their max |value|; the training shapes
               (train: B=4, S=2048, H=16, KH=8; train_moe: B=2, S=2048,
               H=64, KH=4, a GQA group of 16; Dh=128, bf16, tensor cores),
               an f32 shape at Dh 64 and a bf16 one at Dh 32 (CUDA cores); the
               forward with and without the lse at the serving and the
               training shape, in turns; the plain backward; SDPA's forward
               and backward at the training shape
 18. train     Qwen3-1.7B, 28 layers, f32 master weights from init_params
               (seed 0), SyntheticLM at seq 2048 and global batch 4,
               remat="full", attn_impl and norm_impl "kernel", AdamW
               (peak 1e-3, warmup 2, 8 steps): one step with the launches
               counted (zeroed just before, read just after: 56 flash, all
               tensor cores, and 225 RMSNorm), the same step from the same
               state and batch on the plain path (blockwise, reference norm;
               loss within 2e-2, grad norm 5e-2, each leaf's gradient
               ‖Δg‖/‖g‖ within 0.1 through the first moments, every
               parameter 2.5 lr);
               8 steps under the Supervisor with an async CheckpointManager
               (save_every 3, a temporary directory), then the same run with
               a fault injected once at step 5: one recovery, the loss trace
               bit for bit the uninterrupted one's (both runs under
               torch.use_deterministic_algorithms); step wall (synchronised,
               median after the first), tokens/s, peak memory, losses and
               grad norms, model FLOPs (roofline.analytic.model_flops) with
               and without the recompute (× 4/3) and their share of the bf16
               peak, one step under the profiler (busy share, top kernels)
 18b. train_moe  Qwen3-MoE cut from 94 layers to 1 at full width (128
               experts top-8 at F 1,536, 64:4 GQA, qk-norm, untied 151,936
               embedding and head; 3.73 B parameters, f32 master weights and
               AdamW moments), SyntheticLM at seq 2048 and global batch 2
               (capacity 320 an expert), remat="full", microbatches=1,
               attn_impl and norm_impl "kernel": one MoE layer's forward and
               backward at that shape under torch.cuda.set_sync_debug_mode(
               "error"); 6 steps in a plain loop (no Supervisor, no
               checkpoint), the first with its launches counted (zeroed just
               before, read just after: 2 flash, all tensor cores, and 9
               RMSNorm): step wall (synchronised, median of steps 2-6),
               tokens/s, peak memory, losses finite and falling, model FLOPs
               and their share of the bf16 peak with and without the
               recompute, and without the untied embedding lookup (6 · V
               · D · tokens of the count: a gather); one step under the
               profiler; under
               torch.use_deterministic_algorithms, each order-sensitive MoE
               op (dispatch index_add, position cumsum, gather backward) and
               one whole step reported as "ok" or the error it raises; then
               end to end, one step on the kernel path against the same
               step from the same state and batch on the plain path at 64
               experts (the kernel step's parameters and moments moved to
               the host first; the train phase's bars; routing flips per
               MoE layer, those of the 64-expert model)
 18c. train_mesh  a world-1 NCCL process group on an in-process store and
               a (1, 1) ("data", "model") mesh (destroyed at the end):
               Qwen3-1.7B at train's shape (28 layers, B=4 × S=2048, remat
               full, flash and RMSNorm kernels), its state DTensors placed
               by runtime.elastic.state_shardings under default_rules, 3
               steps under sharding.act.activation_rules, the first with
               its launches counted (zeroed just before, read just after:
               56 flash, all tensor cores, and 225 RMSNorm, each kernel on
               its device's shards via local_map); that step against the
               unsharded kernel step from the same state and batch at
               train's bars (step_vs_plain, each leaf at TRAIN_GRAD_RTOL),
               with the leaves equal bit for bit counted; step wall
               (median of steps 2-3), tokens/s, peak memory beside train's
               from the same call, one more step under the profiler (busy
               share, kernels, top kernels); a checkpoint
               written from the mesh state and restored with its
               shardings, every leaf bit for bit and placed as before;
               then one full-width Qwen3-MoE MoE layer (128 experts top-8,
               D 4096, F 1536) in f32 at B=2 × S=2048, dropless (capacity
               factor 8, the reference's own shard_map test), through
               moe_apply_shard_map against moe_apply on the same weights:
               forward and backward under sync-debug "error", 2 expert
               all-to-alls forward and 2 backward, y and aux within 1e-5,
               every gradient finite and within 1e-5 of its max
 19. kernels   one line per ported kernel (launches, error, times, bound;
               flash and SSD also their launches per route; phase-sim its
               launches per path, the serve phases' among them; flash, SSD
               and RMSNorm their launches in each serving run (serve_moe:
               Jamba's, and Qwen3-MoE's as serve_moe_qwen3) and flash and
               RMSNorm in one train step of each train phase (train_mesh's
               as train_mesh_step), flash its
               forward times with the lse)

then the card's ``nvidia-smi`` name/power-limit line and, last, the result
object. The ``dryrun`` phase (before ``kernels``) holds the dry run to a
real Qwen3-1.7B step on the (1, 1) mesh, runs three decode cells through
the dry run's CLI, and runs the ten ``train_4k × 16x16`` cells cut to one
layer cycle, one line each (``layout_cell``), against the reference's
compiled dry run in ``tests/data/ref_dryrun_train_4k.json``
(``launch.dryrun.layout_bars``: argument bytes equal, temp bytes, flops
and collective bytes within their bars), the four large stacks also at
two cycles (``depth_bars``: what a cycle adds, and the full depth within
80 GB).

    python3 chip_smoke.py --train-mesh-wall [--src OTHER_CHECKOUT]

runs only the train_mesh phase (this tree's model code, or another
checkout's ``src/``), whose line holds the mesh step's wall: run it for two
trees in one call to compare them on one card.

    python3 chip_smoke.py --kernel-times [--src OTHER_CHECKOUT] [--outputs FILE]

times only the four kernels (this tree's, or another checkout's ``src/``):
phase-sim at B = 4, 256 and 4096, flash and SSD at their serving shapes and
S=2048, RMSNorm at the serving rows; and prints one JSON line: run it for
two trees in one call to compare them on one card. ``--outputs FILE``
saves the phase-sim kernel's outputs on fixed inputs to FILE, or, where
FILE exists, counts the outputs that differ from it bit for bit. Any failed check ends the run with a non-zero exit code and no
result line; so does a machine with no CUDA device. The script imports the
port only (``src/repro_torch``), never JAX or the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

REL_TOL = 1e-5  # kernel vs plain version, every output column
# every output the kernel must reproduce, plus the per-block telemetry
CHECK_KEYS = (
    "latency_s", "finish_s", "bneck_code", "bneck_kind_s", "alp_time_s",
    "traffic_bytes", "n_phases", "wl_latency_s", "energy_j", "power_w",
    "area_mm2", "fitness", "all_done", "pe_bneck_s", "mem_bneck_s",
    "noc_bneck_s",
)
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PARITY_BATCHES = (1, 4, 256, 4096)
# outputs held bit for bit: the codes, phase counts, argmaxes and done flag
EXACT_KEYS = ("bneck_code", "n_phases", "all_done", "top_bneck_pe", "top_bneck_mem")
# synthetic graphs (sized_scenario) around the one-warp path's edge (31, 32,
# 33 tasks), whole and ragged words, up to the largest block; the plain
# version holds (B, T, T) tensors, so the batch shrinks as T grows
TASK_CASES = [(t, n, b) for t in (1, 28, 31, 32, 33, 64) for n in (1, 2, 8) for b in PARITY_BATCHES]
TASK_CASES += [(257, n, b) for n in (1, 2, 8) for b in (1, 4, 256)]
TASK_CASES += [(1024, n, b) for n in (1, 2, 8) for b in (1, 4)]
TIMING_BATCHES = (4, 256, 4096)
DISTINCT = 256  # distinct designs per parity population (tiled up to B)
GOLDEN_CELLS = ("audio.farsi.s7.it150", "ar_complex.farsi.s3.it120")
MAIN_ITERATIONS = 500


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(phase: str, why: str, **kw) -> None:
    emit(phase, ok=False, error=why, **kw)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def chain_designs(g, n_noc: int, count: int, seed: int):
    """``count`` designs with an ``n_noc``-deep chain, built as the explorer
    builds them: real NoC forks on a randomized single-NoC design, then
    random remapping so routes span the chain."""
    from repro_torch.core import Design, make_accelerator, make_mem
    from repro_torch.core.moves import apply_fork

    rng = random.Random(seed)
    tasks = sorted(g.tasks)
    out = []
    for _ in range(count):
        d = Design.base(g)
        noc0 = d.noc_chain[0]
        for _ in range(rng.randint(2, 4) + 2 * max(0, n_noc - 3)):  # deep chains need blocks to split
            if rng.random() < 0.5:
                t = rng.choice(tasks)
                b = d.add_block(make_accelerator(t, rng.choice((100, 400))),
                                attach_to=noc0)
                d.task_pe[t] = b.name
            else:
                d.add_block(make_mem(rng.choice(("dram", "sram")),
                                     rng.choice((100, 800)), 32),
                            attach_to=noc0)
        for _ in range(100 * n_noc):  # a NoC with fewer than 2 blocks refuses: pick another
            if len(d.noc_chain) == n_noc:
                break
            apply_fork(d, g, rng.choice(d.noc_chain))
        if len(d.noc_chain) != n_noc:
            raise RuntimeError(f"no {n_noc}-NoC chain from NoC forks on this design")
        pes, mems = d.pes(), d.mems()
        for t in tasks:
            d.task_pe[t] = rng.choice(pes)
            d.task_mem[t] = rng.choice(mems)
        out.append(d)
    return out


def population(g, budget, n_noc: int, b: int, seed: int, db, slots: int = 0):
    """Rows for ``b`` candidates on the host: ``min(b, DISTINCT)`` distinct
    designs with Eq.-7 budgets, tiled up to ``b`` rows. ``slots`` pads the
    PE/MEM slot axes as the backend's shape buckets do (0: no padding)."""
    import numpy as np

    from repro_torch.core import random_single_noc_designs
    from repro_torch.core.phase_sim_torch import EncodedWorkload, encode_batch, fill_budget

    enc = EncodedWorkload.of(g)
    k = min(b, DISTINCT)
    if n_noc == 1:
        designs = random_single_noc_designs(g, k, seed=seed)
    else:
        designs = chain_designs(g, n_noc, k, seed=seed)
    rows = encode_batch(designs, g, db, enc, n_pe=slots, n_mem=slots, n_noc=n_noc)
    for j in range(k):
        fill_budget(rows, j, enc, budget.latency_s, budget.power_w, budget.area_mm2, 0.05)
    reps = -(-b // k)
    rows = {key: np.concatenate([v] * reps, 0)[:b] for key, v in rows.items()}
    return enc, rows


def sized_scenario(t: int, seed: int, db):
    """A workload of exactly ``t`` tasks and its calibrated budget, from the
    repo's own generator of AR-like graphs (``synthetic_family``: chains,
    fan-outs and merges); ``t = 1`` is its first task alone."""
    from repro_torch.core import synthetic_family
    from repro_torch.core.tdg import TaskGraph
    from repro_torch.core.workloads import synthetic_budget

    sc = synthetic_family(seed, 1, db, min_tasks=max(t, 2), max_tasks=max(t, 2))[0]
    if t > 1:
        return sc.tdg, sc.budget
    g = TaskGraph(sc.tdg.name)
    g.add_task(next(iter(sc.tdg.tasks.values())))
    return g, synthetic_budget(g, db)


RANDOM_DAG_TASKS = (40, 64, 100)
RANDOM_DAG_SEEDS = (0, 1, 2)
RANDOM_DAG_DESIGNS = 16


def random_dag(t: int, seed: int):
    """A random task graph of ``t`` tasks: each earlier task is a parent of
    a later one with probability 0.08; work is log-uniform in 1e5–1e7 ops,
    read and write intensities uniform in 1–16 ops/byte (burst and llp the
    task defaults). Deterministic in (t, seed)."""
    import numpy as np

    from repro_torch.core.tdg import Task, TaskGraph

    rng = np.random.default_rng(seed)
    g = TaskGraph(f"rand{t}_{seed}")
    for i in range(t):
        work = float(10.0 ** rng.uniform(5.0, 7.0))
        i_rd, i_wr = (float(x) for x in rng.uniform(1.0, 16.0, 2))
        g.add_task(Task(f"t{i}", work, i_rd, i_wr))
        for j in range(i):
            if rng.random() < 0.08:
                g.add_edge(f"t{j}", f"t{i}")
    return g


def random_dag_rows(t: int, seed: int, db, b: int = RANDOM_DAG_DESIGNS):
    """``b`` random single-NoC designs (``random_single_noc_designs``) of
    :func:`random_dag` (t, seed), with the calibrated budget."""
    from repro_torch.core import calibrated_budget, random_single_noc_designs
    from repro_torch.core.phase_sim_torch import EncodedWorkload, encode_batch, fill_budget

    g = random_dag(t, seed)
    bud = calibrated_budget(db)
    enc = EncodedWorkload.of(g)
    rows = encode_batch(random_single_noc_designs(g, b, seed=seed), g, db, enc)
    for j in range(b):
        fill_budget(rows, j, enc, bud.latency_s, bud.power_w, bud.area_mm2, 0.05)
    return g, enc, rows


def compare(want, got):
    """(max relative error, max absolute error, worst key, problems): the
    problems name outputs of the wrong dtype and integer outputs (codes,
    phase counts, argmaxes, the done flag) that are not exactly equal."""
    import torch

    worst_rel, worst_abs, worst_key = 0.0, 0.0, ""
    for key in CHECK_KEYS:
        a, b = want[key], got[key]
        if a.shape != b.shape:
            return float("inf"), float("inf"), f"{key}: shape {tuple(b.shape)}", []
        if a.numel() == 0:
            continue
        a64, b64 = a.double(), b.double()
        diff = (a64 - b64).abs()
        rel = (diff / a64.abs().clamp(min=1e-12)).max().item()
        ab = diff.max().item()
        if rel > worst_rel:
            worst_rel, worst_key = rel, key
        worst_abs = max(worst_abs, ab)
    bad = [k for k in EXACT_KEYS if got[k].dtype != (torch.bool if k == "all_done" else torch.int32)]
    bad += [f"{k} differs" for k in EXACT_KEYS if k not in bad and not torch.equal(got[k], want[k])]
    return worst_rel, worst_abs, worst_key, bad


def column_errors(want, got) -> dict:
    """Worst relative error per output column (codes and counts included)."""
    out = {}
    for key in CHECK_KEYS:
        a64, b64 = want[key].double(), got[key].double()
        out[key] = ((a64 - b64).abs() / a64.abs().clamp(min=1e-12)).max().item() if a64.numel() else 0.0
    return out


def cuda_time_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` run ``reps`` times back to back: a
    sleep kernel holds the stream while the host enqueues, so the events
    bracket the launches and not the host's enqueue rate."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Synchronised wall time per call (the plain version is host-launch
    bound: hundreds of small PyTorch ops per call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(rows, enc, n_phases) -> tuple:
    """Least time the card could take for one launch on these inputs: the
    larger of bytes (each input read once, each output written once) over
    HBM bandwidth and f32 operations over the f32 peak. The count is the
    function's work as the first design's task-long loops do it, with this
    run's phase counts, and stays so (the bitmask design skips most of those
    iterations, but a bound that shrank with each redesign would measure
    nothing): per phase and candidate T² for the ready set, 4·T² for the
    PE/MEM shares, 2·T² per NoC for the link loads, ~30·T elementwise; after
    the loop T·(S_pe + 2·S_mem) for the slot sums and ~50·T for the rollup;
    the parent mask as T² bytes."""
    from repro_torch.kernels.phase_sim.kernel import out_layout

    b, t = rows["task_pe"].shape
    s_pe, s_mem, n_noc = rows["pe_peak"].shape[1], rows["mem_bw"].shape[1], rows["noc_bw"].shape[1]
    n_wl = len(enc.wl_names)
    bytes_in = 4 * (5 * t) + t * t  # work, rd, wr, burst, wl_id; parent mask bytes
    bytes_in += sum(v.element_size() * v.numel() for v in rows.values())
    bytes_out = 4 * b * out_layout(t, s_pe, s_mem, n_noc, n_wl)["width"]
    nbytes = bytes_in + bytes_out
    phases = float(n_phases.double().sum().item())
    ops = phases * (t * t * (5 + 2 * n_noc) + 30 * t) + b * (t * (s_pe + 2 * s_mem) + 50 * t)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def timed(fn):
    """(fn(), seconds it took)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ---- the device chain block -------------------------------------------------------
CHAIN_K = 32  # iterations per fused block
CHAIN_RS = (1, 16, 256)  # chain populations timed
CHAIN_BLOCKS = 3  # timed blocks per population (after one untimed)
CHAIN_SAME = (0, 5, 15)  # chains held equal between R = 16 and R = 256
CHAIN_EXPLORE_ITERATIONS = 512


def sync_errors():
    """A context in which a host synchronisation on the card raises."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def guard():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return guard


def same_block(a, b, chains=None) -> bool:
    """Two chain blocks equal bit for bit on the given chains: sampled rows,
    accepts, fitness trace and every carry leaf."""
    import numpy as np

    idx = list(range(a.move_idx.shape[0])) if chains is None else list(chains)
    return (all(a.seq(i) == b.seq(i) for i in idx)
            and np.array_equal(a.fit_trace[idx], b.fit_trace[idx])
            and all(np.array_equal(x[idx], y[idx]) for x, y in zip(a.carry, b.carry)))


def carry_errors(want, got) -> tuple:
    """The worst relative error over two carries' float leaves, and the
    integer leaves that differ."""
    import numpy as np

    worst, differ = 0.0, []
    for name, a, b in zip(want._fields, want, got):
        if np.issubdtype(a.dtype, np.floating):
            a, b = a.astype(np.float64), b.astype(np.float64)
            if a.size:
                worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12))))
        elif not np.array_equal(a, b):
            differ.append(name)
    return worst, differ


def chain_phases(card: str, db, bud, main_sims_per_s: float) -> dict:
    """Phases ``chain`` and ``chain_explore``: the device chain block on
    ar_complex (farsi menu, alloc on) through the phase-sim kernel. Returns
    the kernel launches that each path's run made."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.core import (
        DeviceChainRunner, Explorer, ExplorerConfig, ar_complex, distance, prng,
        random_single_noc_designs, simulate,
    )
    from repro_torch.core.device_explore import block_draws
    from repro_torch.kernels.phase_sim import kernel as K

    g = ar_complex()
    design = random_single_noc_designs(g, 1, seed=1)[0]
    kw = dict(menu="farsi", alloc=True, seed=1)
    runner = DeviceChainRunner(g, db)
    runner.loop_guard = sync_errors()  # no host sync inside the K iterations
    t0 = time.perf_counter()
    per_r, blocks = [], {}
    for r in CHAIN_RS:
        runner.run_chains(design, bud, r=r, k=CHAIN_K, **kw)  # builds the block, first launches
        walls, launches = [], []
        for _ in range(CHAIN_BLOCKS):
            torch.cuda.synchronize()
            K.phase_sim_cuda.launches = 0
            t1 = time.perf_counter()
            res = runner.run_chains(design, bud, r=r, k=CHAIN_K, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            launches.append(K.phase_sim_cuda.launches)
        blocks[r] = res
        wall = float(np.median(walls))
        per_r.append(dict(r=r, k=CHAIN_K, wall_s=wall, walls_s=walls,
                          chain_steps_per_s=r * CHAIN_K / wall, launches_per_block=launches,
                          accepted=int(res.accepted.sum()), best_fitness=float(res.fitness.min())))
        if any(n != CHAIN_K for n in launches):
            fail("chain", f"a block of K = {CHAIN_K} did not launch the kernel K times", per_r=per_r)
    # where a step's time goes: device kernels per step and the busy share
    # of one R = 16 block, and the host cost of a block's threefry draws (K
    # key splits, then the K steps' Gumbel noise and accept uniforms in one
    # batched call each) per step
    runner.loop_guard = contextlib.nullcontext  # the profiler synchronises
    prof = device_profile(lambda: runner.run_chains(design, bud, r=16, k=CHAIN_K, **kw))
    runner.loop_guard = sync_errors()
    keys = prng.fold_in(prng.prng_key(1), torch.arange(16)).cuda()

    def draws():
        block_draws(keys, CHAIN_K, blocks[16].n_moves)

    draw_prof = device_profile(draws)
    draw_us = wall_ms(draws, 20) * 1e3 / CHAIN_K
    host = runner.run_chains_host(design, bud, r=1, n_steps=CHAIN_K, **kw)
    if not same_block(blocks[1], host):
        fail("chain", "the fused R = 1 block differs from the host loop", per_r=per_r)
    if not same_block(blocks[16], blocks[256], CHAIN_SAME):
        fail("chain", "chains differ between R = 16 and R = 256", chains=list(CHAIN_SAME))
    cpu = DeviceChainRunner(g, db, device="cpu").run_chains(design, bud, r=4, k=16, **kw)
    card4 = runner.run_chains(design, bud, r=4, k=16, **kw)
    cpu_fit = float(np.max(np.abs(cpu.fit_trace.astype(np.float64) - card4.fit_trace)
                           / np.maximum(np.abs(cpu.fit_trace), 1e-12)))
    cpu_carry, carry_differ = carry_errors(cpu.carry, card4.carry)
    if not all(cpu.seq(i) == card4.seq(i) for i in range(4)):
        fail("chain", "the block on the card and on the CPU sampled different sequences",
             fit_trace_rel_err=cpu_fit)
    if cpu_fit > REL_TOL or cpu_carry > REL_TOL or carry_differ:
        fail("chain", "the block on the card priced off the CPU's", fit_trace_rel_err=cpu_fit,
             carry_rel_err=cpu_carry, integer_leaves_differ=carry_differ)
    emit("chain", ok=True, graph="ar_complex", menu="farsi", alloc=True, per_r=per_r,
         host_loop_wall_s=host.wall_s, host_loop_steps_per_s=CHAIN_K / host.wall_s,
         fused_equals_host_loop=True, chains_equal_r16_r256=list(CHAIN_SAME),
         cuda_equals_cpu_sequences=True, cpu_vs_cuda_fit_trace_rel_err=cpu_fit,
         cpu_vs_cuda_carry_rel_err=cpu_carry,
         profile_r16={"wall_ms": prof["wall_ms"], "kernels_per_step": prof["kernels"] / CHAIN_K,
                      "busy_ms": prof["busy_ms"], "busy_share": prof["busy_share"],
                      "top": prof["top"]},
         draws_per_step={"host_us": draw_us, "kernels": draw_prof["kernels"] / CHAIN_K},
         n_compiles=runner.n_compiles, sync_debug_mode="error", card=card,
         seconds=time.perf_counter() - t0)

    # ---- chain_explore: Explorer.run_chains end to end --------------------------
    K.phase_sim_cuda.launches = 0
    t0 = time.perf_counter()
    ex = Explorer(g, db, bud, ExplorerConfig(
        policy="farsi", chain_r=16, chain_k=CHAIN_K, chain_alloc=True,
        max_iterations=CHAIN_EXPLORE_ITERATIONS, seed=1))
    res = ex.run_chains()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    explore_launches = K.phase_sim_cuda.launches
    st = ex.backend.stats()
    fit = distance(simulate(res.best_design, g, db), bud).fitness(0.05)
    last = res.history[-1]["fitness"]
    rel = abs(fit - last) / max(abs(fit), 1e-12)
    summary = dict(
        r=res.chain_r, k=CHAIN_K, iterations=res.iterations, n_sims=res.n_sims, wall_s=wall,
        chain_steps_per_s=res.chain_r * res.iterations / wall,
        main_path_sims_per_s=main_sims_per_s, n_dispatches=st.n_dispatches,
        n_compiles=ex.backend.chain_runner().n_compiles, launches=explore_launches,
        converged=res.converged, repriced_fitness=fit, history_fitness=last,
        fitness_rel_err=rel, device=str(ex.backend.device), card=card,
    )
    if ex.backend.device.type != "cuda":
        fail("chain_explore", "the explorer did not price on the card", **summary)
    blocks_run = -(-CHAIN_EXPLORE_ITERATIONS // CHAIN_K)
    if explore_launches != res.iterations + 1 or st.n_dispatches != blocks_run + 1:
        fail("chain_explore", "not one launch per iteration plus the winner's decode", **summary)
    if rel > REL_TOL:
        fail("chain_explore", "best design re-priced off the search's fitness", **summary)
    emit("chain_explore", ok=True, **summary)
    return {"chain": {f"R={p['r']}": p["launches_per_block"][-1] for p in per_r},
            "chain_explore": explore_launches}


def analysis_phase(card: str) -> int:
    """Phase ``analysis``: the port's analysis gate on the card,
    ``run_all(device="cuda")``. Any live finding fails the run. Returns the
    phase-sim launches the gate made (the audited chain block's and the
    wrapper's, each warmed, audited and profiled)."""
    import torch

    from repro_torch.analysis import PASSES, run_all
    from repro_torch.analysis.launch_audit import CHAIN_K
    from repro_torch.kernels.phase_sim import kernel as K

    torch.cuda.synchronize()
    K.phase_sim_cuda.launches = 0
    report = {}
    t0 = time.perf_counter()
    findings = run_all(device="cuda", report=report)
    seconds = time.perf_counter() - t0
    launches = K.phase_sim_cuda.launches
    live = [f for f in findings if f.live]
    summary = dict(
        live_per_pass={p: sum(f.pass_name == p for f in live) for p in PASSES},
        suppressed=sum(f.suppressed for f in findings),
        baselined=sum(f.baselined for f in findings),
        bucket_grid=report.get("bucket_grid"), phase_sim_plain=report.get("phase_sim_plain"),
        chain_block=report.get("chain_block"), wrapper=report.get("ops.phase_sim"),
        launches=launches, seconds=seconds, card=card,
    )
    if live:
        fail("analysis", "live findings", findings=[f.render() for f in live], **summary)
    if summary["chain_block"]["launches"] != CHAIN_K or summary["wrapper"]["launches"] != 1:
        fail("analysis", "the audit's launch counts are off", **summary)
    emit("analysis", ok=True, **summary)
    return launches


# ---- the serve layer: DseService, the design cache, chaos, Campaign ----------------
SERVE_POLICIES = ("farsi", "naive_sa", "bottleneck", "locality")
SERVE_REPLICAS = 16  # × the four policies: 64 host-loop sessions, seed rep % 4
SERVE_ITERATIONS = 60
SERVE_LATE_AFTER = 5  # ticks before the second half of the sessions joins
SERVE_CHAINS = (1, 2)  # seeds of the two chain-batched sessions (chain_r 16, chain_k 32)
SERVE_SOLO = ("r0.farsi", "r9.naive_sa", "chain.s1")  # re-run alone: up front, late, chain
CHAOS = dict(dispatch_fault_rate=0.1, nan_row_rate=0.05, straggler_rate=0.05,
             straggler_delay_s=0.001, crash_rate=0.02)  # tests/test_serve_faults.py's combined
# the reference chaos sweep's 12 iterations: longer searches draw a poisoned
# row or a crash for every session, and none is left to hold to the
# fault-free run (seed 7 leaves one of the eight untouched)
CHAOS_SESSIONS, CHAOS_ITERATIONS = 8, 12
CAMPAIGN_POLICIES = ("farsi", "naive_sa", "bottleneck")
CAMPAIGN_SEEDS = (0, 1)


def tally_dispatches(backend, tally: dict) -> None:
    """Count, apart from the kernel's own launch counter, the dispatches of
    ``backend`` that reach the kernel: a candidate dispatch that sends at
    least one row to the card (its ``n_batched`` grows; rows the store or a
    same-dispatch alias serves send none) is one launch, and a chain block of
    K iterations is K launches."""
    evaluate, run_chains = backend.evaluate_candidates, backend.run_chains

    def counted_evaluate(cands):
        before = backend.stats().n_batched
        out = evaluate(cands)
        rows = backend.stats().n_batched - before
        tally["dispatches"] += rows > 0
        tally["rows"] += rows
        tally["candidates"] += len(cands)
        tally["calls"] += 1
        return out

    def counted_chains(req):
        out = run_chains(req)
        tally["chain_launches"] += req.k
        return out

    backend.evaluate_candidates = counted_evaluate
    backend.run_chains = counted_chains


def new_tally() -> dict:
    return dict(calls=0, dispatches=0, rows=0, candidates=0, chain_launches=0)


def moves(res) -> list:
    return [(h["iteration"], h["move"], bool(h["accepted"]), h["fitness"]) for h in res.history]


def serve_sessions(svc, g, bud, distinct: bool = False):
    """Submit phase serve_dse's sessions, the second half of the host-loop
    sessions after ``SERVE_LATE_AFTER`` ticks: the replicated scenario's 66
    (seed rep % 4, and the two chain-batched sessions), or with ``distinct``
    64 host-loop sessions of 64 distinct seeds (no session repeats another)."""
    from repro_torch.core import ExplorerConfig

    def host(rep, pol):
        seed = rep * len(SERVE_POLICIES) + SERVE_POLICIES.index(pol) if distinct else rep % 4
        return svc.submit(f"r{rep}.{pol}", g, bud, ExplorerConfig(
            policy=pol, seed=seed, max_iterations=SERVE_ITERATIONS))

    half = SERVE_REPLICAS // 2
    handles = [host(rep, pol) for rep in range(half) for pol in SERVE_POLICIES]
    handles += [] if distinct else [svc.submit(f"chain.s{seed}", g, bud, ExplorerConfig(
        policy="farsi", seed=seed, max_iterations=SERVE_ITERATIONS, chain_r=16,
        chain_k=CHAIN_K, chain_alloc=True)) for seed in SERVE_CHAINS]
    for _ in range(SERVE_LATE_AFTER):
        svc.step()
    handles += [host(rep, pol) for rep in range(half, SERVE_REPLICAS) for pol in SERVE_POLICIES]
    return handles


def serve_counters(st) -> dict:
    return {k: getattr(st, k) for k in (
        "n_failed", "n_dispatch_faults", "n_degraded", "n_fallback", "n_nonfinite_rejected",
        "n_retries", "n_bisects", "n_restarts", "n_deadline_exceeded", "n_straggler_ticks",
        "n_degraded_evals")}


def serve_run(db, g, bud, distinct: bool):
    """One run of ``serve_sessions`` on a fresh service with a DesignStore:
    its handles, stats, backend, the dispatches counted apart, and the
    kernel's launches (zeroed just before the run, read just after)."""
    import torch

    from repro_torch.kernels.phase_sim import kernel as K
    from repro_torch.serve import DesignStore, DseService

    svc = DseService(db, store=DesignStore())
    tally = new_tally()
    tally_dispatches(svc.scheduler.backend_for(g), tally)
    torch.cuda.synchronize()
    K.phase_sim_cuda.launches = 0
    t1 = time.perf_counter()
    handles = serve_sessions(svc, g, bud, distinct=distinct)
    st = svc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    (backend,) = svc.scheduler.backends().values()
    return svc, handles, st, backend, tally, K.phase_sim_cuda.launches, wall


def serve_summary(st, backend, tally, launches, wall, main_sims_per_s) -> dict:
    """A serve run's numbers: throughput, latency, cache, dispatch shape,
    launches beside the dispatches that reached the kernel, counters."""
    bst = backend.stats()
    return dict(
        sessions=st.n_sessions, done=st.n_done, iterations=SERVE_ITERATIONS, ticks=st.n_ticks,
        wall_s=wall, service_wall_s=st.wall_s, n_evals=st.n_evals,
        evals_per_s=st.n_evals / wall, main_path_sims_per_s=main_sims_per_s,
        latency_p50_s=st.latency_percentile(50), latency_p95_s=st.latency_percentile(95),
        cache_hits=st.cache_hits, cache_misses=st.cache_misses,
        cache_bypasses=st.cache_bypasses, cache_evictions=st.cache_evictions,
        cache_hit_rate=st.cache_hit_rate,
        shared_dispatches=tally["dispatches"], rows_dispatched=tally["rows"],
        rows_per_shared_dispatch=tally["rows"] / max(tally["dispatches"], 1),
        candidates_per_call=tally["candidates"] / max(tally["calls"], 1),
        chain_block_launches=tally["chain_launches"], launches=launches,
        expected_launches=tally["dispatches"] + tally["chain_launches"],
        backend_dispatches=bst.n_dispatches, backend_device=str(backend.device),
        encode_s=bst.encode_s, dispatch_s=bst.dispatch_s, decode_s=bst.decode_s,
        backend_wall_s=bst.wall_s, **serve_counters(st),
    )


def serve_faults(summary: dict, handles, st, backend, tally) -> str | None:
    """What a fault-free serve run must not show, or None."""
    if backend.device.type != "cuda":
        return "the service did not price on the card"
    if st.n_done != len(handles) or any(not h.done for h in handles):
        return "not every session completed"
    if any(summary[k] for k in ("n_failed", "n_dispatch_faults", "n_degraded", "n_fallback",
                                "n_nonfinite_rejected")):
        return "a fault-free run reported a fault, degradation or fallback"
    if summary["launches"] != summary["expected_launches"] or tally["dispatches"] == 0:
        return "launches differ from the dispatches that reached the kernel"
    return None


def worst_repriced(results, g, db, bud) -> float:
    """The largest relative gap between a best design re-priced by the scalar
    simulator and its session's last fitness."""
    from repro_torch.core import distance, simulate

    worst = 0.0
    for r in results:
        fit = distance(simulate(r.best_design, g, db), bud).fitness(0.05)
        worst = max(worst, abs(fit - r.history[-1]["fitness"]) / max(abs(fit), 1e-12))
    return worst


def serve_phases(card: str, db, bud, main_sims_per_s: float) -> dict:
    """Phases ``serve_dse``, ``serve_chaos`` and ``campaign``: the serve
    layer on the card, every shared dispatch through the phase-sim kernel.
    Returns the kernel launches that each phase's run made."""
    import torch

    from repro_torch.core import Campaign, ExplorerConfig, ar_complex, audio
    from repro_torch.kernels.phase_sim import kernel as K
    from repro_torch.serve import DesignStore, DispatchFailed, DseService, FaultInjector

    # ---- serve_dse: 64 host-loop sessions (half join mid-flight) + 2 chain ---
    g = ar_complex()
    t0 = time.perf_counter()
    svc, handles, st, backend, tally, launches, wall = serve_run(db, g, bud, distinct=False)
    summary = dict(graph="ar_complex", scenario="replicated: 16 replicas of 4 (policy, seed)",
                   chain_sessions=len(SERVE_CHAINS),
                   late_joiners=SERVE_REPLICAS // 2 * len(SERVE_POLICIES),
                   **serve_summary(st, backend, tally, launches, wall, main_sims_per_s),
                   launches_counted_as="one per candidate dispatch that sent at least one row "
                                       "to the card (rows served by the store or aliased send "
                                       "none) plus K per chain block; counted by wrapping the "
                                       "backend's evaluate_candidates and run_chains, apart "
                                       "from the kernel's counter",
                   card=card)
    why = serve_faults(summary, handles, st, backend, tally)
    if why:
        fail("serve_dse", why, **summary)
    if st.cache_hit_rate <= 0.3:
        fail("serve_dse", "cache hit rate at or below 0.3", **summary)
    by_name = {h.name: h.result for h in handles}
    for rep in range(4):
        for pol in SERVE_POLICIES:
            runs = [by_name[f"r{r}.{pol}"] for r in range(rep, SERVE_REPLICAS, 4)]
            if any(r.best_distance.city_block() != runs[0].best_distance.city_block()
                   or moves(r) != moves(runs[0]) for r in runs):
                fail("serve_dse", f"replicas of {pol} seed {rep} ended apart", **summary)
    worst = worst_repriced(by_name.values(), g, db, bud)
    summary["repriced_fitness_max_rel_err"] = worst
    if worst > REL_TOL:
        fail("serve_dse", "a best design re-priced off its session's fitness", **summary)
    solo = {}
    for name in SERVE_SOLO:
        alone = DseService(db)
        req = svc._sessions[name].request
        h = alone.submit(name, g, bud, req.config)
        alone.run()
        a, b = h.result, by_name[name]
        solo[name] = moves(a) == moves(b) and (
            a.best_distance.city_block() == b.best_distance.city_block())
    summary["solo_reruns_identical"] = solo
    if not all(solo.values()):
        fail("serve_dse", "a session re-run alone walked other moves", **summary)
    # the device's busy share: the same sessions again, under the profiler
    prof_svc = DseService(db, store=DesignStore())
    prof = device_profile(lambda: (serve_sessions(prof_svc, g, bud), prof_svc.run()))
    summary["profile"] = {k: prof[k] for k in ("wall_ms", "kernels", "busy_ms", "busy_share",
                                               "top")}
    # the same service shape with 64 distinct seeds: no session repeats
    # another, so the cache serves only what searches revisit, and the
    # dispatches carry what a shared service of distinct searches sends
    _, d_handles, d_st, d_backend, d_tally, d_launches, d_wall = serve_run(
        db, g, bud, distinct=True)
    distinct = dict(scenario="64 distinct seeds, no chain session",
                    **serve_summary(d_st, d_backend, d_tally, d_launches, d_wall,
                                    main_sims_per_s))
    distinct["repriced_fitness_max_rel_err"] = worst_repriced(
        [h.result for h in d_handles if h.done], g, db, bud)
    summary["distinct_seeds"] = distinct
    why = serve_faults(distinct, d_handles, d_st, d_backend, d_tally)
    if why:
        fail("serve_dse", f"distinct seeds: {why}", **summary)
    if distinct["repriced_fitness_max_rel_err"] > REL_TOL:
        fail("serve_dse", "distinct seeds: a best design re-priced off its session's fitness",
             **summary)
    summary["seconds"] = time.perf_counter() - t0
    emit("serve_dse", ok=True, **summary)
    serve_launches = {"replicated": launches, "distinct_seeds": d_launches}

    # ---- serve_chaos: seeded faults, twice, against a fault-free run -------------
    t0 = time.perf_counter()

    def chaos(faults):
        svc = DseService(db, faults=faults)
        tally = new_tally()
        tally_dispatches(svc.scheduler.backend_for(g), tally)
        hs = [svc.submit(f"s{i}", g, bud, ExplorerConfig(
            policy=SERVE_POLICIES[i % 4], seed=i, max_iterations=CHAOS_ITERATIONS),
            max_restarts=2) for i in range(CHAOS_SESSIONS)]
        try:
            st = svc.run()
        except Exception as exc:  # the guarantee under test: nothing escapes run()
            fail("serve_chaos", f"an exception escaped DseService.run(): {exc!r}")
        out = {h.name: (h.state, h.degraded, type(h.error).__name__,
                        moves(h.result) if h.done else None,
                        h.result.best_distance.city_block() if h.done else None) for h in hs}
        return svc, st, out, tally

    torch.cuda.synchronize()
    K.phase_sim_cuda.launches = 0
    fi_a = FaultInjector(seed=7, **CHAOS)
    svc_a, st_a, out_a, tally_a = chaos(fi_a)
    torch.cuda.synchronize()
    chaos_launches = K.phase_sim_cuda.launches
    fi_b = FaultInjector(seed=7, **CHAOS)
    _, st_b, out_b, _ = chaos(fi_b)
    _, st_0, out_0, _ = chaos(None)
    affected = fi_a.affected_sessions() | set(svc_a.failures())
    affected |= {n for n, s in svc_a._sessions.items() if s.degraded}
    untouched = [n for n in out_0 if n not in affected]
    counters = serve_counters(st_a)
    timed_counters = ("n_straggler_ticks",)  # flagged against wall-clock EMAs
    replayed = {k: v for k, v in counters.items() if k not in timed_counters}
    summary = dict(
        graph="ar_complex", sessions=CHAOS_SESSIONS, iterations=CHAOS_ITERATIONS, seed=7,
        rates=CHAOS, injected=fi_a.counts(), schedule_len=len(fi_a.schedule),
        done=st_a.n_done, ticks=st_a.n_ticks, **counters, untouched=untouched,
        affected=sorted(affected), launches=chaos_launches,
        expected_launches=tally_a["dispatches"] + tally_a["chain_launches"], card=card,
    )
    if fi_a.schedule != fi_b.schedule or out_a != out_b or replayed != {
            k: v for k, v in serve_counters(st_b).items() if k not in timed_counters}:
        fail("serve_chaos", "two runs under one injector seed differ", **summary)
    if any(out_a[n] != out_0[n] for n in untouched) or not untouched:
        fail("serve_chaos", "a session the injector never touched differs from the "
             "fault-free run", **summary)
    if st_a.n_dispatch_faults != fi_a.counts()["dispatch"]:
        fail("serve_chaos", "dispatch faults beside the injected ones", **summary)
    if chaos_launches != summary["expected_launches"]:
        fail("serve_chaos", "launches differ from the dispatches that reached the kernel",
             **summary)
    if st_0.n_dispatch_faults or st_0.n_degraded or st_0.n_failed or st_0.n_fallback:
        fail("serve_chaos", "the fault-free run reported a fault", **serve_counters(st_0))
    # a real fault of the kernel on the card (its launch raising) fails the
    # session with the fault on __cause__: the CPU fallback must not price it
    import repro_torch.kernels.phase_sim.ops as ops

    launch = ops.phase_sim_rows

    def broken(*a, **k):
        raise RuntimeError("phase-sim launch failed")

    ops.phase_sim_rows = broken
    try:
        svc_f = DseService(db)
        h_f = svc_f.submit("broken", g, bud, ExplorerConfig(
            seed=0, max_iterations=CHAOS_ITERATIONS))
        st_f = svc_f.run()
    finally:
        ops.phase_sim_rows = launch
    summary["card_fault"] = dict(
        failed=h_f.failed, degraded=h_f.degraded, error=type(h_f.error).__name__,
        cause=repr(getattr(h_f.error, "__cause__", None)), n_degraded=st_f.n_degraded,
        n_degraded_evals=st_f.n_degraded_evals,
        fallback_backends=len(svc_f.scheduler.fallback_backends()))
    if not (h_f.failed and isinstance(h_f.error, DispatchFailed)
            and isinstance(h_f.error.__cause__, RuntimeError) and st_f.n_degraded == 0
            and not svc_f.scheduler.fallback_backends()):
        fail("serve_chaos", "a kernel fault on the card did not fail its session", **summary)
    summary["seconds"] = time.perf_counter() - t0
    emit("serve_chaos", ok=True, **summary)

    # ---- campaign: audio + ar_complex × seeds × policies, with and without the store --
    t0 = time.perf_counter()
    graphs = {"audio": audio(), "ar_complex": ar_complex()}

    def campaign(store):
        camp = Campaign(db, store=store)
        tally = new_tally()
        for gname, cg in graphs.items():
            tally_dispatches(camp.backend_for(cg), tally)
            for pol in CAMPAIGN_POLICIES:
                for seed in CAMPAIGN_SEEDS:
                    camp.add(f"{gname}.{pol}.s{seed}", cg, bud, ExplorerConfig(
                        policy=pol, seed=seed, max_iterations=SERVE_ITERATIONS))
        torch.cuda.synchronize()
        K.phase_sim_cuda.launches = 0
        res = camp.run()
        torch.cuda.synchronize()
        n = K.phase_sim_cuda.launches
        agg = res.aggregate
        return res, dict(
            wall_s=res.wall_s, runs=len(res.runs), n_sims=agg["n_sims_total"],
            dispatches=sum(b.n_dispatches for b in res.backend_stats.values()),
            launches=n, expected_launches=tally["dispatches"] + tally["chain_launches"],
            cache_hits=agg["cache_hits_total"], cache_misses=agg["cache_misses_total"],
            cache_bypasses=agg["cache_bypass_total"], cache_hit_rate=agg["cache_hit_rate"],
            converged=agg["n_converged"], best_distance_mean=agg["best_distance_mean"],
            devices=sorted({str(b.device) for b in camp._scheduler.backends().values()}))

    cached, with_store = campaign(DesignStore())
    plain, without = campaign(None)
    summary = dict(graphs=list(graphs), policies=list(CAMPAIGN_POLICIES),
                   seeds=list(CAMPAIGN_SEEDS), iterations=SERVE_ITERATIONS,
                   with_store=with_store, without_store=without, card=card)
    if with_store["devices"] != ["cuda:0"] or without["devices"] != ["cuda:0"]:
        fail("campaign", "the campaign did not price on the card", **summary)
    for side in (with_store, without):
        if side["launches"] != side["expected_launches"]:
            fail("campaign", "launches differ from the dispatches that reached the kernel",
                 **summary)
    same = all(
        moves(cached.runs[n]) == moves(r) and cached.runs[n].n_sims == r.n_sims
        and cached.runs[n].best_distance.city_block() == r.best_distance.city_block()
        for n, r in plain.runs.items())
    if not same or list(cached.runs) != list(plain.runs):
        fail("campaign", "runs with the store differ from runs without it", **summary)
    summary["seconds"] = time.perf_counter() - t0
    emit("campaign", ok=True, **summary)
    return {"serve_dse": serve_launches, "serve_chaos": chaos_launches,
            "campaign": {"with_store": with_store["launches"],
                         "without_store": without["launches"]}}


# ---- the serving path and its flash-attention kernel ---------------------------
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # the reference's bars (tests/test_kernels.py)
FLASH_HEADS = {"mha": 8, "gqa": 2, "mqa": 1}  # KV heads under 8 query heads
FLASH_SEQS = (128, 512, 1024, 2048, 1000)  # 1000: no multiple of the 64-row tile
PREFILL = dict(b=4, s=512, h=16, kh=8, dh=128)  # Qwen3-1.7B's prefill shape in serve
PREFILL_SEQS = (512, 1000)  # serve's layout in the parity grid: its S and a ragged one
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 512, 32
SERVE_ATOL, SERVE_RTOL = 5e-2, 2e-2  # the reference's bar (tests/test_train_serve.py)


def report_build(phase, module, future) -> None:
    """The phase line of a kernel build started in the pool: seconds, the
    library, the flags and ptxas's per-instance registers, shared memory
    and spills; nvcc's own message if it failed."""
    try:
        lib, seconds = future.result()
    except RuntimeError as e:  # nvcc's own message
        fail(phase, str(e)[-4000:])
    ptxas = [ln.strip() for ln in module.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln or "entry function" in ln]
    emit(phase, ok=True, seconds=seconds, library=os.path.relpath(lib, HERE),
         flags=" ".join(module.NVCC_FLAGS), ptxas=ptxas)


def flash_inputs(b, h, kh, s, dh, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, n, s, dh, generator=g, device="cuda").to(dtype) for n in (h, kh, kh)]


def flash_check(q, k, v, causal, tol) -> tuple:
    """The kernel's wrapper against its plain version on the same inputs:
    (max abs error, max abs error over max |plain|, every element within
    tol + tol*|plain| and the output in q's dtype)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_reference

    got = FK.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = attention_reference(q, k, v, causal=causal)
    mag = want.double().abs()
    d = (got.double() - want.double()).abs()
    ab = d.max().item()
    rel = ab / max(mag.max().item(), 1e-30)  # against the output's scale
    return ab, rel, bool((d <= tol + tol * mag).all()) and got.dtype == q.dtype


def fused_check(b, h, kh, s, dh, dtype, seed, causal, tol) -> tuple:
    """``ops.flash_attention`` on q, k, v sliced from one fused (B, S,
    H + 2 KH, Dh) projection (strided views the kernel reads in place),
    against the plain version on the same views; as :func:`flash_check`."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_reference

    g = torch.Generator(device="cuda").manual_seed(seed)
    fused = torch.randn(b, s, h + 2 * kh, dh, generator=g, device="cuda").to(dtype)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kh], fused[:, :, h + kh:]
    got = flash_attention(q, k, v, causal, s, s)  # blocks: the whole sequence
    torch.cuda.synchronize()
    want = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=causal).transpose(1, 2)
    mag = want.double().abs()
    d = (got.double() - want.double()).abs()
    ab = d.max().item()
    ok = bool((d <= tol + tol * mag).all()) and got.dtype == dtype and got.is_contiguous()
    return ab, ab / max(mag.max().item(), 1e-30), ok


def flash_bound(b, h, kh, s, dh, itemsize, causal=True) -> tuple:
    """Least time for one call: each input read once and the output written
    once, over HBM bandwidth; the causal products this input needs
    (4·Dh per query-key pair, S(S+1)/2 pairs per head) over the bf16 peak."""
    nbytes = itemsize * (2 * b * h * s * dh + 2 * b * kh * s * dh)
    pairs = s * (s + 1) / 2 if causal else s * s
    ops = 4.0 * b * h * dh * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def device_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: synchronised wall ms, the
    device's busy ms (the union of its kernels' intervals), the busy share,
    and the five kernels with the most device time. A trace without device
    events reports the busy figures as None (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(
        wall_ms=wall_ms, kernels=len(spans),
        busy_ms=busy_us / 1e3 if spans else None,
        busy_share=busy_us / 1e3 / wall_ms if spans else None,
        top=[{"kernel": name[:90], "ms": ms, "count": n} for name, (ms, n) in top],
    )


def flash_phases(card: str, build_future) -> dict:
    """Phases 7-10; returns the flash kernel's entry of the kernels line."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.launch.serve import extend_cache, generate
    from repro_torch.models.model import Model, RunFlags, init_params
    from repro_torch.train.step import make_prefill_step

    report_build("flash_build", FK, build_future)

    # ---- flash_parity ----------------------------------------------------------
    t0 = time.perf_counter()
    worst = {dt: {"max_abs_err": 0.0, "max_rel_err": 0.0} for dt in FLASH_TOL}
    # (b, h, kh, s, dh, layout): one batch row of 8 query heads over the grid,
    # then serve's own layout (4 batch rows, 16 query heads over 8 KV heads)
    shapes = [(1, 8, kh, s, dh, heads) for dh in (16, 32, 64, 128, 256)
              for heads, kh in FLASH_HEADS.items() for s in FLASH_SEQS]
    shapes += [(PREFILL["b"], PREFILL["h"], PREFILL["kh"], s, PREFILL["dh"], "serve")
               for s in PREFILL_SEQS]
    # the tensor-core route's own cases (bf16): Dh 64 and 256 at serve's
    # layout, GQA 16:1, and q, k, v sliced from one fused projection
    # (B, S, H + 2 KH, Dh), read in place through ops.flash_attention
    tc_shapes = [(2, 16, 8, s, dh, "serve") for dh in (64, 256) for s in PREFILL_SEQS]
    tc_shapes += [(1, 32, 2, s, 128, "gqa16") for s in PREFILL_SEQS]
    fused_shapes = [(2, 16, 8, s, dh, "fused") for dh in (64, 128) for s in PREFILL_SEQS]
    failures, n_cases, seed = [], 0, 0
    routes = dict.fromkeys(FK.ROUTES, 0)
    cases = [(dtype, shape) for dtype in (torch.bfloat16, torch.float32) for shape in shapes]
    cases += [(torch.bfloat16, shape) for shape in tc_shapes + fused_shapes]
    cases += [(torch.float32, shape) for shape in fused_shapes]  # the CUDA-core route, strided
    for dtype, (b, h, kh, s, dh, layout) in cases:
        dt = str(dtype).split(".")[-1]
        for causal in (True, False):
            seed += 1
            before = dict(FK.launches_by_route)
            if layout == "fused":
                ab, rel, ok = fused_check(b, h, kh, s, dh, dtype, seed, causal, FLASH_TOL[dt])
            else:
                q, k, v = flash_inputs(b, h, kh, s, dh, dtype, seed)
                ab, rel, ok = flash_check(q, k, v, causal, FLASH_TOL[dt])
            want_route = FK.route(dtype, dh)
            took = [r for r in FK.ROUTES if FK.launches_by_route[r] != before[r]]
            routes[want_route] += 1
            w = worst[dt]
            w["max_abs_err"], w["max_rel_err"] = max(w["max_abs_err"], ab), max(w["max_rel_err"], rel)
            n_cases += 1
            if not ok or took != [want_route]:
                failures.append({"dtype": dt, "b": b, "h": h, "kh": kh, "dh": dh, "layout": layout,
                                 "s": s, "causal": causal, "max_abs_err": ab, "route": took})
    if failures:
        fail("flash_parity", "kernel disagrees with the plain version or took the wrong route",
             failures=failures[:12], n_failed=len(failures), n_cases=n_cases)
    emit("flash_parity", ok=True, cases=n_cases, cases_by_route=routes, worst=worst, tol=FLASH_TOL,
         check="|kernel - plain| <= tol + tol*|plain| everywhere; "
               "max_rel_err = max|kernel - plain| / max|plain| per case",
         seconds=time.perf_counter() - t0)

    # ---- flash_timing ------------------------------------------------------------
    timings = {}
    for s in (PREFILL["s"], 2048):
        shape = dict(PREFILL, s=s)
        b, h, kh, dh = shape["b"], shape["h"], shape["kh"], shape["dh"]
        q, k, v = flash_inputs(b, h, kh, s, dh, torch.bfloat16, seed=s)
        ab, rel, ok = flash_check(q, k, v, True, FLASH_TOL["bfloat16"])
        w = worst["bfloat16"]
        w["max_abs_err"], w["max_rel_err"] = max(w["max_abs_err"], ab), max(w["max_rel_err"], rel)
        if not ok:
            fail("flash_timing", "kernel disagrees with the plain version on the timed inputs",
                 shape=shape, max_abs_err=ab, tol=FLASH_TOL["bfloat16"])
        ms = cuda_time_ms(lambda: FK.flash_attention_cuda(q, k, v, causal=True), 50)
        # what the model pays: the entry point on (B, S, H, Dh) activations
        qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ops_ms = cuda_time_ms(lambda: flash_attention(qm, km, vm, causal=True), 50)
        plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v, causal=True), 10)
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 50)
        bound_ms, bound_by, nbytes, nops = flash_bound(b, h, kh, s, dh, 2)
        timings[s] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        timings[s].update(ops_ms=ops_ms, bound_share=bound_ms / ms, route=FK.route(q.dtype, dh))
        emit("flash_timing", ok=True, shape=shape, dtype="bfloat16", causal=True, bytes=nbytes,
             ops=nops, max_abs_err=ab, max_rel_err=rel, card=card, **timings[s])

    # ---- serve: Qwen3-1.7B, full width and depth, through the kernel -------------
    cfg = get_config("qwen3-1.7b")
    model, init_s = timed(lambda: init_params(cfg, seed=0, dtype=torch.bfloat16))
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                                      generator=g, device="cuda")}
    kernel_flags = RunFlags(attn_impl="kernel")
    generate(model, cfg, prompt, 1, flags=kernel_flags)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    t0 = time.perf_counter()
    tokens, last = generate(model, cfg, prompt, SERVE_NEW, flags=kernel_flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FK.flash_attention_cuda.launches
    by_route = dict(FK.launches_by_route)
    peak = torch.cuda.max_memory_allocated()

    # the prefill and cache extension alone, through the same entry point
    # (median of 3); a decode step is the rest of the counted run's time
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, first = generate(model, cfg, prompt, 0, max_len=SERVE_PROMPT + SERVE_NEW,
                            flags=kernel_flags)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = sorted(walls)[1]
    decode_ms = (wall * 1e3 - prefill_ms) / SERVE_NEW
    # where the time goes: generate with 0 and with 4 new tokens under the profiler
    profile = {
        "prefill": device_profile(lambda: generate(
            model, cfg, prompt, 0, max_len=SERVE_PROMPT + SERVE_NEW, flags=kernel_flags)),
        "prefill_and_4_steps": device_profile(lambda: generate(
            model, cfg, prompt, 4, max_len=SERVE_PROMPT + SERVE_NEW, flags=kernel_flags)),
    }
    # the cache generate builds: the prefill step's, extended to the capacity
    with torch.inference_mode():
        cache_dev = extend_cache(cfg, make_prefill_step(cfg, kernel_flags)(model, prompt)[1],
                                 SERVE_PROMPT + SERVE_NEW)[0]["k"].device
    summary = dict(
        model="qwen3-1.7b", layers=cfg.n_layers, d_model=cfg.d_model, batch=SERVE_BATCH,
        prompt=SERVE_PROMPT, new_tokens=SERVE_NEW, init_s=init_s, wall_s=wall,
        tokens_per_s=SERVE_BATCH * SERVE_NEW / wall, prefill_ms=prefill_ms,
        prefill_ms_runs=walls, decode_ms_per_step=decode_ms, max_memory_allocated=peak,
        flash_launches=launches, flash_launches_by_route=by_route, params_device=str(model.device),
        cache_device=str(cache_dev), card=card, profile=profile,
    )
    if model.device.type != "cuda" or cache_dev.type != "cuda":
        fail("serve", "the model or its cache is not on the card", **summary)
    if launches != cfg.n_layers or by_route["tensor_cores"] != cfg.n_layers:
        fail("serve", f"{launches} flash launches ({by_route}), want one per layer "
             f"({cfg.n_layers}), all on the tensor-core route", **summary)
    finite = all(bool(torch.isfinite(x).all()) for x in (last, first))
    valid = tokens.shape == (SERVE_BATCH, SERVE_NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    if not (finite and valid):
        fail("serve", "non-finite logits or invalid token ids", finite=finite, valid=valid, **summary)

    # the plain attention path on the same weights: 2 layers held to the
    # reference's bar, all 28 reported (bf16 differences compound with depth)
    tree = model.tree()
    shallow = Model(dict(tree, layers=tree["layers"][:2]))
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    plain_flags = RunFlags(attn_impl="full")
    compare = {}
    with torch.inference_mode():
        for name, c, m in (("2_layers", cfg2, shallow), ("28_layers", cfg, model)):
            got = make_prefill_step(c, kernel_flags)(m, prompt)[0]
            want = make_prefill_step(c, plain_flags)(m, prompt)[0]
            d = (got - want).abs()
            compare[name] = dict(
                max_abs_diff=d.max().item(),
                within_bar=bool((d <= SERVE_ATOL + SERVE_RTOL * want.abs()).all()),
                top1_agree=(got.argmax(-1) == want.argmax(-1)).float().mean().item())
    if not compare["2_layers"]["within_bar"]:
        fail("serve", "2-layer kernel path disagrees with the plain path", plain=compare, **summary)
    emit("serve", ok=True, plain=compare, bar={"atol": SERVE_ATOL, "rtol": SERVE_RTOL}, **summary)

    t = timings[PREFILL["s"]]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:33",
        "launches": launches,
        "launches_by_route": by_route,
        "max_abs_err": max(w["max_abs_err"] for w in worst.values()),
        "max_rel_err": max(w["max_rel_err"] for w in worst.values()),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }


# ---- the Mamba-2 serving path and its SSD and RMSNorm kernels -------------------
SSD_Y_TOL = {"bfloat16": 5e-2, "float32": 1e-3}  # the reference's bars (tests/test_kernels.py)
SSD_H_TOL = 1e-3
# (B, S, H, P, N, chunk, x dtype, B/C dtype): tests/test_kernels.py's SSD_CASES
# (B and C in f32, as the reference draws them), then Mamba2-370m's prefill in
# serve_mamba (B and C in x's dtype, slices of one projection as the model
# passes them) at chunk 64 (the model's) and 128 (ops.ssd's default), and S=2048
SSD_CASES = [
    (2, 128, 4, 16, 8, 32, "float32", "float32"),
    (1, 256, 2, 64, 128, 128, "float32", "float32"),
    (2, 64, 8, 32, 16, 16, "float32", "float32"),
    (1, 128, 4, 64, 32, 64, "bfloat16", "float32"),
] + [(4, 512, 32, 64, 128, q, dt, dt) for dt in ("bfloat16", "float32") for q in (64, 128)] + [
    (4, 2048, 32, 64, 128, 64, "bfloat16", "bfloat16"),
] + [  # chunk = P = N = 128 on the CUDA-core route: its head dim split over two blocks
    (2, 512, 4, 128, 128, 128, xd, bcd)
    for xd, bcd in (("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"))
]
# (B, S, H, P, N, chunk, x dtype, B/C dtype, head-dim columns per block):
# CUDA-core instances small enough to run whole, run again with the head dim
# split across blocks; y and h must be equal bit for bit
SSD_SPLIT_CASES = [(2, 512, 4, 128, 128, 64, "float32", "float32", pb) for pb in (64, 48, 32)] + [
    (1, 256, 2, 64, 128, 128, "float32", "bfloat16", 32),
    (2, 256, 4, 128, 64, 128, "bfloat16", "float32", 64),
]
# (B, S, H, P, N, chunk, dtype) through ops.ssd on x, B and C sliced from one
# projection, as the model passes them: bf16 takes the tensor-core route at
# every chunk, P and N in {64, 128} and S from one chunk to 2048, reading the
# slices in place; f32 the CUDA-core route
SSD_ROUTE_CASES = [(2 if s < 2048 else 1, s, 4 if s < 2048 else 2, p, n, q, dt)
                   for dt in ("bfloat16", "float32") for q in (64, 128) for p in (64, 128)
                   for n in (64, 128) for s in sorted({q, 512, 2048})]
SSD_TILE_TOL = 1e-4  # one wgmma tile vs torch.matmul, over the tile's largest |value|
SSD_TIMED = (4, 512, 32, 64, 128, 64)  # serve_mamba's prefill shape, bf16, chunk 64
RMS_TOL = {"bfloat16": 2e-2, "float32": 1e-5}  # the reference's bars (tests/test_kernels.py)
# tests/test_kernels.py's shapes, serve_mamba's prefill and decode rows, a ragged count
# an odd width, Qwen3's qk-norm rows (d = 128 over B*S*H rows), wide rows
# (d = 8192, Mistral's 12288: a block per row), train_moe's d_model rows (B*S = 4096
# rows of Qwen3-MoE's 4096)
RMS_SHAPES = [(64, 128), (2, 32, 64), (256, 512), (2048, 1024), (2048, 2048), (4, 1024),
              (4, 2048), (1000, 1024), (33, 1001), (32768, 128), (16, 8192), (4, 12288),
              (4096, 4096)]
RMS_MISALIGNED = ((2048, 1024), (33, 1001), (4, 12288))  # x one element past 16-byte alignment
RMS_HOST_CALLS = 200  # calls per host-cost sample (well inside the launch queue)
RMS_DTYPES = (("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"))  # x, w
RMS_TIMED = ((2048, 1024), (2048, 2048), (4, 1024), (4, 2048))  # the headline first


def ssd_inputs(b, s, h, p, n, dtype, bc_dtype, seed):
    """x, dt = softplus(normal), a = -exp(normal), B, C: the reference's
    test recipe, on the card."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(b, s, h, generator=g, device="cuda"))
    a = -torch.exp(torch.randn(h, generator=g, device="cuda"))
    bm = torch.randn(b, s, n, generator=g, device="cuda").to(bc_dtype)
    cm = torch.randn(b, s, n, generator=g, device="cuda").to(bc_dtype)
    return x, dt, a, bm, cm


def ssd_model_inputs(b, s, h, p, n, seed, dtype=None):
    """x, dt, a, B, C as Mamba-2's prefill passes them: x, B and C views of
    one (B, S, H*P + 2N) projection (strided, not copied; bf16 unless
    ``dtype`` says otherwise), dt (B, S, H) f32 = softplus(normal),
    a = -exp(normal)."""
    import torch
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn(b, s, h * p + 2 * n, generator=g, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(b, s, h, generator=g, device="cuda"))
    a = -torch.exp(torch.randn(h, generator=g, device="cuda"))
    return xbc[..., :h * p].view(b, s, h, p), dt, a, xbc[..., h * p:h * p + n], xbc[..., h * p + n:]


def ssd_check(args, chunk, y_tol, fn=None) -> dict:
    """A kernel entry point (``fn``, by default ``ssd_cuda``) against the
    plain version on the same inputs: worst abs errors of y and h, y's abs
    error over max |plain y|, the route the call took, and whether every
    element is within tol + tol*|plain| in the right dtypes on the route
    ``kernel.route`` names."""
    import torch

    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ref import ssd_reference

    before = dict(SK.launches_by_route)
    y, h = (fn or SK.ssd_cuda)(*args, chunk)
    torch.cuda.synchronize()
    took = [r for r in SK.ROUTES if SK.launches_by_route[r] != before[r]]
    want_route = SK.route(args[0].dtype, args[3].dtype, chunk, args[0].shape[-1], args[3].shape[-1])
    y_ref, h_ref = ssd_reference(*args, chunk=chunk)
    dy = (y.double() - y_ref.double()).abs()
    dh = (h.double() - h_ref.double()).abs()
    ok = bool((dy <= y_tol + y_tol * y_ref.double().abs()).all()) and bool(
        (dh <= SSD_H_TOL + SSD_H_TOL * h_ref.double().abs()).all())
    ok = ok and y.dtype == args[0].dtype and h.dtype == torch.float32 and took == [want_route]
    y_abs = dy.max().item()
    return dict(y_abs=y_abs, y_rel=y_abs / max(y_ref.double().abs().max().item(), 1e-30),
                h_abs=dh.max().item(), route=took[0] if len(took) == 1 else took, ok=ok)


def ssd_bound(b, s, h, p, n, q, x_item, bc_item) -> tuple:
    """Least time for one call: x and dt, B, C read once, y and the final h
    written once, over HBM bandwidth; the products over the causal pairs of
    each chunk (C.B^T and its product with x dt: 2(N + P) per pair, Q(Q+1)/2
    pairs) and the carried state (C.h and the state update: 4PN per token),
    per head, over the bf16 peak."""
    nbytes = 2 * b * s * h * p * x_item + 4 * b * s * h + 2 * b * s * n * bc_item + 4 * b * h * p * n
    ops = float(b * h * (s // q)) * (q * (q + 1) * (n + p) + 4 * q * p * n)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def host_us(fn) -> float:
    """Host microseconds per call of an asynchronous launch: the median of
    5 runs of RMS_HOST_CALLS back-to-back calls, each started on an idle
    stream and timed without waiting for the card (the queue never fills)."""
    import torch

    fn()
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RMS_HOST_CALLS):
            fn()
        samples.append((time.perf_counter() - t0) * 1e6 / RMS_HOST_CALLS)
    torch.cuda.synchronize()
    return sorted(samples)[2]


def rms_bound(rows, d, x_item, w_item) -> tuple:
    """Least time for one call: x read once, w read once, the output written
    once, over HBM bandwidth; 4 f32 operations an element over the f32 peak."""
    nbytes = 2 * rows * d * x_item + d * w_item
    ops = 4.0 * rows * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def mamba_phases(card: str, ssd_build, rms_build) -> list:
    """Phases 11-16; returns the SSD and RMSNorm kernels' entries of the
    kernels line."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels._build import stream_handle
    from repro_torch.kernels.rmsnorm import kernel as NK
    from repro_torch.kernels.rmsnorm.ops import rmsnorm as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ops import ssd as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_reference
    from repro_torch.launch.serve import extend_cache, generate
    from repro_torch.models.model import Model, RunFlags, init_params
    from repro_torch.train.step import make_prefill_step

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    report_build("ssd_build", SK, ssd_build)
    report_build("rmsnorm_build", NK, rms_build)

    # ---- ssd_parity ---------------------------------------------------------------
    t0 = time.perf_counter()
    # the tensor-core route's four products, one wgmma tile each, against
    # torch.matmul first (swizzle, descriptors, fragments, the hi/lo split)
    g = torch.Generator(device="cuda").manual_seed(3)
    tc_c, tc_b = (torch.randn(64, 128, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    tc_x = torch.randn(64, 64, generator=g, device="cuda").to(torch.bfloat16)
    tc_h = torch.randn(64, 128, generator=g, device="cuda")
    got = SK.wgmma_tile(tc_c, tc_b, tc_x, tc_h)
    torch.cuda.synchronize()
    cf, bf, xf = tc_c.float(), tc_b.float(), tc_x.float()
    tile_err = {name: ((o - w).abs().max() / w.abs().max()).item() for name, o, w in zip(
        ("c_bT", "c_hT", "s_x", "xT_b"), got, (cf @ bf.T, cf @ tc_h.T, got[0] @ xf, xf.T @ bf))}
    if not max(tile_err.values()) <= SSD_TILE_TOL:
        fail("ssd_parity", "a wgmma tile disagrees with torch.matmul", tile_err=tile_err, tol=SSD_TILE_TOL)
    ssd_worst = {"y_abs": 0.0, "y_rel": 0.0, "h_abs": 0.0}
    cases, failures = [], []

    def ssd_cases():
        for i, (b, s, h, p, n, q, xd, bcd) in enumerate(SSD_CASES):  # ssd_cuda, contiguous
            yield (dict(b=b, s=s, h=h, p=p, n=n, chunk=q, dtype=xd, bc_dtype=bcd, layout="contiguous"),
                   ssd_inputs(b, s, h, p, n, dtypes[xd], dtypes[bcd], seed=100 + i), q, None)
        for i, (b, s, h, p, n, q, xd) in enumerate(SSD_ROUTE_CASES):  # ops.ssd, the model's slices
            yield (dict(b=b, s=s, h=h, p=p, n=n, chunk=q, dtype=xd, bc_dtype=xd, layout="model"),
                   ssd_model_inputs(b, s, h, p, n, seed=200 + i, dtype=dtypes[xd]), q, ssd_ops)

    for case, args, q, fn in ssd_cases():
        r = ssd_check(args, q, SSD_Y_TOL[case["dtype"]], fn)
        case.update(r)
        cases.append(case)
        for key in ssd_worst:
            ssd_worst[key] = max(ssd_worst[key], r[key])
        if not r["ok"]:
            failures.append(case)
    if failures:
        fail("ssd_parity", "kernel disagrees with the plain version or took the wrong route",
             failures=failures, n_cases=len(cases))
    split = []  # the head dim split across blocks against the whole instance, bit for bit
    for i, (b, s, h, p, n, q, xd, bcd, pb) in enumerate(SSD_SPLIT_CASES):
        args = ssd_inputs(b, s, h, p, n, dtypes[xd], dtypes[bcd], seed=300 + i)
        whole = SK.ssd_cuda(*args, q, p_block=p)
        parts = SK.ssd_cuda(*args, q, p_block=pb)
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(whole, parts))
        split.append(dict(b=b, s=s, h=h, p=p, n=n, chunk=q, dtype=xd, bc_dtype=bcd, p_block=pb,
                          bitwise_equal=same))
        if not same:
            fail("ssd_parity", "the split instance differs from the whole one", case=split[-1])
    emit("ssd_parity", ok=True, cases=cases, worst=ssd_worst, tile_err=tile_err, split=split,
         cases_by_route={r: sum(c["route"] == r for c in cases) for r in SK.ROUTES},
         tol={"y": SSD_Y_TOL, "h": SSD_H_TOL, "tile": SSD_TILE_TOL},
         check="|kernel - plain| <= tol + tol*|plain| everywhere, for y and h_final, on the "
               "route kernel.route names",
         seconds=time.perf_counter() - t0)

    # ---- rmsnorm_parity -------------------------------------------------------------
    t0 = time.perf_counter()
    rms_worst = {dt: {"max_abs_err": 0.0, "max_rel_err": 0.0} for dt in RMS_TOL}
    failures, n_cases = [], 0
    for shape, misaligned in [(sh, False) for sh in RMS_SHAPES] + [(sh, True) for sh in RMS_MISALIGNED]:
        for xd, wd in RMS_DTYPES:
            g = torch.Generator(device="cuda").manual_seed(shape[-1] + len(shape))
            n = 1
            for e in shape:
                n *= e
            buf = torch.randn(n + int(misaligned), generator=g, device="cuda").to(dtypes[xd])
            x = buf[int(misaligned):].view(shape)  # misaligned: the element-load path
            w = (torch.randn(shape[-1], generator=g, device="cuda") * 0.1).to(dtypes[wd])
            got = NK.rmsnorm_cuda(x.reshape(-1, shape[-1]), w).reshape(shape)
            torch.cuda.synchronize()
            want = rmsnorm_reference(x, w)
            d = (got.double() - want.double()).abs()
            tol = RMS_TOL[xd]
            ab = d.max().item()
            rel = ab / max(want.double().abs().max().item(), 1e-30)
            wst = rms_worst[xd]
            wst["max_abs_err"], wst["max_rel_err"] = max(wst["max_abs_err"], ab), max(wst["max_rel_err"], rel)
            n_cases += 1
            if not (bool((d <= tol + tol * want.double().abs()).all()) and got.dtype == x.dtype):
                failures.append(dict(shape=shape, dtype=xd, w_dtype=wd, misaligned=misaligned,
                                     max_abs_err=ab))
    if failures:
        fail("rmsnorm_parity", "kernel disagrees with the plain version", failures=failures,
             n_cases=n_cases)
    emit("rmsnorm_parity", ok=True, cases=n_cases, worst=rms_worst, tol=RMS_TOL,
         check="|kernel - plain| <= tol + tol*|plain| everywhere", seconds=time.perf_counter() - t0)

    # ---- ssd_timing -------------------------------------------------------------------
    ssd_t = {}
    for s in (SSD_TIMED[1], 2048):
        b, _, h, p, n, q = SSD_TIMED
        args = ssd_model_inputs(b, s, h, p, n, seed=s)  # x, B, C: the model's slices
        r = ssd_check(args, q, SSD_Y_TOL["bfloat16"])
        if not r["ok"]:
            fail("ssd_timing", "kernel disagrees with the plain version on the timed inputs",
                 s=s, check=r)
        for key in ssd_worst:
            ssd_worst[key] = max(ssd_worst[key], r[key])
        ms = cuda_time_ms(lambda: SK.ssd_cuda(*args, q), 50)
        ops_ms = cuda_time_ms(lambda: ssd_ops(*args, chunk=q), 50)  # what the model calls
        plain_ms = cuda_time_ms(lambda: ssd_reference(*args, chunk=q), 10)
        bound_ms, bound_by, nbytes, nops = ssd_bound(b, s, h, p, n, q, 2, 2)
        ssd_t[s] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        ssd_t[s].update(ops_ms=ops_ms, bound_share=bound_ms / ms, ssd_route=r["route"])
        emit("ssd_timing", ok=True, shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=q), dtype="bfloat16",
             layout="model", bytes=nbytes, ops=nops, check=r, card=card, **ssd_t[s])

    # ---- rmsnorm_timing -----------------------------------------------------------------
    rms_t = {}
    for rows, d in RMS_TIMED:
        g = torch.Generator(device="cuda").manual_seed(rows + d)
        x = torch.randn(rows, d, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(d, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        want = rmsnorm_reference(x, w)
        got = NK.rmsnorm_cuda(x, w)
        dd = (got.double() - want.double()).abs()
        if not bool((dd <= RMS_TOL["bfloat16"] * (1 + want.double().abs())).all()):
            fail("rmsnorm_timing", "kernel disagrees with the plain version on the timed inputs",
                 shape=[rows, d], max_abs_err=dd.max().item())
        w1 = (1.0 + w.float()).to(torch.bfloat16)  # the library's weight, made outside the timing
        ms = cuda_time_ms(lambda: NK.rmsnorm_cuda(x, w), 200)
        plain_ms = cuda_time_ms(lambda: rmsnorm_reference(x, w), 50)
        library_ms = cuda_time_ms(lambda: F.rms_norm(x, (d,), weight=w1, eps=1e-6), 200)
        bound_ms, bound_by, nbytes, nops = rms_bound(rows, d, 2, 2)
        rms_t[(rows, d)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                                bound_by=bound_by)
        rms_t[(rows, d)].update(
            bound_share=bound_ms / ms,
            host_us=host_us(lambda: rms_ops(x, w)),  # the model's entry point
            host_us_kernel=host_us(lambda: NK.rmsnorm_cuda(x, w)),
            host_us_library=host_us(lambda: F.rms_norm(x, (d,), weight=w1, eps=1e-6)))
        if (rows, d) == RMS_TIMED[2]:  # where a decode call's host time goes
            out = torch.empty_like(x)
            lib, dev = NK._LIB.get(), x.get_device()
            args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), 1, 1, rows, d, 1e-6, stream_handle(dev))
            rms_t[(rows, d)]["host_us_parts"] = dict(
                empty_like=host_us(lambda: torch.empty_like(x)),
                current_stream=host_us(lambda: torch.cuda.current_stream(x.device).cuda_stream),
                stream_handle=host_us(lambda: stream_handle(dev)),
                ctypes_launch=host_us(lambda: lib.rmsnorm_launch(*args)))
        emit("rmsnorm_timing", ok=True, shape=[rows, d], dtype="bfloat16", w_dtype="bfloat16",
             bytes=nbytes, ops=nops, max_abs_err=dd.max().item(), card=card, **rms_t[(rows, d)])

    # ---- serve_mamba: Mamba2-370m, full width and depth, through both kernels -------------
    cfg = get_config("mamba2-370m")
    model, init_s = timed(lambda: init_params(cfg, seed=0, dtype=torch.bfloat16))
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                                      generator=g, device="cuda")}
    kernel_flags = RunFlags(ssd_impl="kernel", norm_impl="kernel")
    generate(model, cfg, prompt, 1, flags=kernel_flags)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SK.reset_launches()
    NK.rmsnorm_cuda.launches = 0
    t0 = time.perf_counter()
    tokens, last = generate(model, cfg, prompt, SERVE_NEW, flags=kernel_flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ssd_launches, rms_launches = SK.ssd_cuda.launches, NK.rmsnorm_cuda.launches
    ssd_by_route = dict(SK.launches_by_route)
    peak = torch.cuda.max_memory_allocated()

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, first = generate(model, cfg, prompt, 0, max_len=SERVE_PROMPT + SERVE_NEW,
                            flags=kernel_flags)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = sorted(walls)[1]
    decode_ms = (wall * 1e3 - prefill_ms) / SERVE_NEW
    profile = {
        "prefill": device_profile(lambda: generate(
            model, cfg, prompt, 0, max_len=SERVE_PROMPT + SERVE_NEW, flags=kernel_flags)),
        "prefill_and_4_steps": device_profile(lambda: generate(
            model, cfg, prompt, 4, max_len=SERVE_PROMPT + SERVE_NEW, flags=kernel_flags)),
    }
    with torch.inference_mode():
        cache = extend_cache(cfg, make_prefill_step(cfg, kernel_flags)(model, prompt)[1],
                             SERVE_PROMPT + SERVE_NEW)
    cache_devices = sorted({str(t.device) for c in cache for t in c.values()})
    # per call (the prefill, then each decode step): norm1 and the gated norm of
    # every layer, and the final norm
    want_rms = (2 * cfg.n_layers + 1) * (1 + SERVE_NEW)
    summary = dict(
        model="mamba2-370m", layers=cfg.n_layers, d_model=cfg.d_model, batch=SERVE_BATCH,
        prompt=SERVE_PROMPT, new_tokens=SERVE_NEW, init_s=init_s, wall_s=wall,
        tokens_per_s=SERVE_BATCH * SERVE_NEW / wall, prefill_ms=prefill_ms,
        prefill_ms_runs=walls, decode_ms_per_step=decode_ms, max_memory_allocated=peak,
        ssd_launches=ssd_launches, ssd_launches_by_route=ssd_by_route, rmsnorm_launches=rms_launches,
        want_launches={"ssd": cfg.n_layers, "rmsnorm": want_rms},
        params_device=str(model.device), cache_devices=cache_devices, card=card, profile=profile,
    )
    if model.device.type != "cuda" or cache_devices != ["cuda:0"]:
        fail("serve_mamba", "the model or its cache is not on the card", **summary)
    if ssd_launches != cfg.n_layers or rms_launches != want_rms:
        fail("serve_mamba", "kernel launches differ from one SSD per layer and "
             "2 x layers + 1 norms per call", **summary)
    if ssd_by_route["tensor_cores"] != cfg.n_layers:
        fail("serve_mamba", "SSD launches off the tensor-core route", **summary)
    finite = all(bool(torch.isfinite(x).all()) for x in (last, first))
    valid = tokens.shape == (SERVE_BATCH, SERVE_NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    if not (finite and valid):
        fail("serve_mamba", "non-finite logits or invalid token ids", finite=finite, valid=valid,
             **summary)

    # the plain path (ssd_reference, layers.rms_norm) on the same weights: 2
    # layers held to the reference's bar, all 48 reported
    tree = model.tree()
    shallow = Model(dict(tree, layers=tree["layers"][:2]))
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    compare = {}
    with torch.inference_mode():
        for name, c, m in (("2_layers", cfg2, shallow), ("48_layers", cfg, model)):
            got = make_prefill_step(c, kernel_flags)(m, prompt)[0]
            want = make_prefill_step(c, RunFlags())(m, prompt)[0]
            d = (got - want).abs()
            compare[name] = dict(
                max_abs_diff=d.max().item(),
                within_bar=bool((d <= SERVE_ATOL + SERVE_RTOL * want.abs()).all()),
                top1_agree=(got.argmax(-1) == want.argmax(-1)).float().mean().item())
    if not compare["2_layers"]["within_bar"]:
        fail("serve_mamba", "2-layer kernel path disagrees with the plain path", plain=compare,
             **summary)
    emit("serve_mamba", ok=True, plain=compare, bar={"atol": SERVE_ATOL, "rtol": SERVE_RTOL},
         **summary)

    st, rt = ssd_t[SSD_TIMED[1]], rms_t[RMS_TIMED[0]]
    return [{
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:27",
        "launches": ssd_launches,
        "launches_by_route": ssd_by_route,
        "max_abs_err": ssd_worst["y_abs"],
        "max_rel_err": ssd_worst["y_rel"],
        "h_max_abs_err": ssd_worst["h_abs"],
        **st,
    }, {
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:18",
        "launches": rms_launches,
        "max_abs_err": max(w["max_abs_err"] for w in rms_worst.values()),
        "max_rel_err": max(w["max_rel_err"] for w in rms_worst.values()),
        **rt,
    }]


# ---- the MoE serving path: Jamba and Qwen3-MoE through the three LLM kernels ----------
# (config, layers served (cut from 32 and 94), layers of the end-to-end comparison
# held to the routing and value bars (0: all reported, none held))
SERVE_MOE = (("jamba-v0.1-52b", 8, 4), ("qwen3-moe-235b-a22b", 4, 0))
MOE_FLIP_MAX = 0.05  # tokens whose top-k expert set differs, kernel vs plain path, per MoE layer


def moe_want_launches(cfg, calls: int) -> dict:
    """Kernel launches one ``generate`` of ``calls`` forward calls (the
    prefill and each decode step) makes: a flash per attention layer and an
    SSD per Mamba-2 layer, in the prefill only; and per call an RMSNorm for
    norm1 and norm2 of every layer with a channel mixer, q- and k-norm of
    every attention layer with qk-norm, the gated norm of every Mamba-2
    layer, and the final norm."""
    kinds = [cfg.block_kinds[i % cfg.cycle_len] for i in range(cfg.n_layers)]
    mlps = [cfg.mlp_kind_at(i % cfg.cycle_len) for i in range(cfg.n_layers)]
    per_call = (cfg.n_layers + sum(m != "none" for m in mlps) + kinds.count("mamba")
                + (2 * kinds.count("attn") if cfg.qk_norm else 0) + 1)
    return {"flash": kinds.count("attn"), "ssd": kinds.count("mamba"), "rmsnorm": per_call * calls}


def routing_flips(got, want, n_experts: int):
    """Per MoE call of two runs (``moe.record_routing`` lists): the share of
    tokens whose top-k expert set differs, and of those whose kept set
    differs, with the second run's margin at the top-k boundary (median over
    all tokens, largest over the flipped ones); and the (T,) mask of tokens
    that agree in both, in every call."""
    import torch

    agree, shares = None, []
    for a, b in zip(got, want):
        t = a["expert_idx"].shape[0]
        flip = (a["expert_idx"].sort(-1).values != b["expert_idx"].sort(-1).values).any(-1)
        kept = [torch.zeros(t, n_experts, dtype=torch.bool, device=flip.device).scatter_(
            1, r["expert_idx"], r["keep"]) for r in (a, b)]
        kept_diff = (kept[0] != kept[1]).any(-1)
        shares.append({"set": flip.float().mean().item(), "kept": kept_diff.float().mean().item(),
                       "gap_median": b["gap"].median().item(),
                       "gap_max_flipped": b["gap"][flip].max().item() if flip.any() else None})
        ok = ~(flip | kept_diff)
        agree = ok if agree is None else agree & ok
    return shares, agree


def moe_path_compare(model, cfg, prompt, flags, n_layers: int) -> dict:
    """The first ``n_layers`` layers' logits on the kernel path (``flags``)
    against the plain path on the same weights: routing flips per MoE layer,
    and the difference over all positions, over the tokens routed alike in
    every MoE layer, and over the positions none of whose causal context
    (the tokens up to it in its sequence) was routed otherwise: attention
    and the SSM carry a flipped token's difference to every later position
    of its sequence. The bar is held on those last."""
    import dataclasses

    import torch

    from repro_torch.models.model import Model, RunFlags, forward
    from repro_torch.models.moe import record_routing

    tree = model.tree()
    m = Model(dict(tree, layers=tree["layers"][:n_layers]))
    c = dataclasses.replace(cfg, n_layers=n_layers)
    with torch.inference_mode():
        with record_routing() as rk:
            got = forward(m, c, prompt, flags)[0]
        with record_routing() as rp:
            want = forward(m, c, prompt, RunFlags())[0]
        flips, alike = routing_flips(rk, rp, cfg.n_experts)
        alike = alike.reshape(got.shape[:2])
        clean = alike.int().cumprod(-1).bool()  # and every earlier token of the sequence
        d = (got - want).abs()
        tok_ok = (d <= SERVE_ATOL + SERVE_RTOL * want.abs()).all(-1)
        out = dict(
            layers=n_layers, moe_layers=len(flips), routing_flips=flips,
            max_set_flip=max(f["set"] for f in flips),
            routed_alike_share=alike.float().mean().item(),
            clean_share=clean.float().mean().item(),
            max_abs_diff=d.max().item(),
            max_abs_diff_routed_alike=d[alike].max().item() if alike.any() else None,
            max_abs_diff_clean=d[clean].max().item() if clean.any() else None,
            within_bar_routed_alike=bool(tok_ok[alike].all()),
            within_bar_clean=bool(tok_ok[clean].all()),
            within_bar_share=tok_ok.float().mean().item(),
            top1_agree=(got.argmax(-1) == want.argmax(-1)).float().mean().item())
    del got, want, d
    return out


def moe_layer_compare(model, cfg, prompt, flags) -> list:
    """Each layer alone on the kernel path (``flags``) and on the plain path,
    from the same input, the plain path's hidden state (teacher-forced: no
    difference or flip carries from one layer into the next). Per layer: at
    an MoE layer its routing flips and margins (``routing_flips``), and the
    difference of its output over all tokens and over those routed alike,
    with the reference's bar on those."""
    import torch

    from repro_torch.models.model import RunFlags, _block_seq, _embed, cast_params
    from repro_torch.models.moe import record_routing

    rows = []
    with torch.inference_mode():
        p = cast_params(model, torch.bfloat16)
        x = _embed(p, cfg, prompt, torch.bfloat16)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for i, lp in enumerate(p["layers"]):
            pos = i % cfg.cycle_len
            runs = []
            for f in (flags, RunFlags()):
                with record_routing() as calls:
                    runs.append((_block_seq(pos, lp, x, cfg, f, positions, None, False)[0], calls))
            (yk, rk), (yp, rp) = runs
            row = {"layer": i, "kind": f"{cfg.block_kinds[pos]}/{cfg.mlp_kind_at(pos)}"}
            alike = torch.ones(b * s, dtype=torch.bool, device=x.device)
            if rk:
                flips, alike = routing_flips(rk, rp, cfg.n_experts)
                row.update(flips[0])
            alike = alike.reshape(b, s)
            d = (yk.float() - yp.float()).abs()
            ok = (d <= SERVE_ATOL + SERVE_RTOL * yp.float().abs()).all(-1)
            row.update(max_abs_diff=d.max().item(), routed_alike_share=alike.float().mean().item(),
                       max_abs_diff_routed_alike=d[alike].max().item(),
                       within_bar_routed_alike=bool(ok[alike].all()))
            rows.append(row)
            x = yp
    return rows


def decode_bound_ms(model, cfg, cache, batch: int) -> tuple:
    """Least time of one decode step: every weight read once (the
    reference's static-capacity dispatch runs every expert every step), the
    embedding only at the batch's rows, each cache tensor read once and the
    Mamba-2 state and conv window written once, over HBM bandwidth."""
    nbytes = sum(t.numel() * t.element_size() for n, t in model.named_parameters() if n != "embed")
    if cfg.input_mode == "tokens" and hasattr(model, "embed"):
        nbytes += batch * cfg.d_model * model.embed.element_size()
    for i, c in enumerate(cache):
        mamba = cfg.block_kinds[i % cfg.cycle_len] != "attn"
        nbytes += sum(t.numel() * t.element_size() * (2 if mamba else 1) for t in c.values())
    return nbytes / PEAK_BYTES_S * 1e3, nbytes


def serve_moe_phase(card: str, models=None, device="cuda", batch=SERVE_BATCH,
                    prompt_len=SERVE_PROMPT, new=SERVE_NEW, profile=True) -> dict:
    """Phase ``serve_moe``: Jamba (one whole 8-layer cycle) and Qwen3-MoE (4
    layers) at full width, seeded random bf16 weights made on the card,
    served through ``generate`` with every flash, SSD and RMSNorm call on its
    kernel. ``models`` ((config, layers held) pairs; :data:`SERVE_MOE` by
    default; 0 layers held: the end-to-end comparison is only reported),
    ``device``, the sizes and ``profile`` exist to rehearse the
    phase on the CPU at a reduced size (no launches are counted there and no
    host sync is checked). Returns each model's kernel launches in its
    counted ``generate``, by config name."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import ARCHS, get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm import kernel as NK
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch.serve import extend_cache, generate
    from repro_torch.models.model import RunFlags, init_params
    from repro_torch.models.moe import capacity, moe_apply
    from repro_torch.train.step import make_prefill_step

    if models is None:
        models = [(dataclasses.replace(get_config(name), n_layers=n), held)
                  for name, n, held in SERVE_MOE]
    on_card = torch.device(device).type == "cuda"
    kernel_flags = RunFlags(attn_impl="kernel", ssd_impl="kernel", norm_impl="kernel")
    out = {}
    for cfg, held in models:
        name, n_layers = cfg.name, cfg.n_layers
        t_phase = time.perf_counter()
        allocated_before = torch.cuda.memory_allocated() if on_card else None
        model, init_s = timed(lambda: init_params(cfg, seed=0, dtype=torch.bfloat16, device=device))
        n_params = sum(t.numel() for t in model.parameters())
        g = torch.Generator(device=device).manual_seed(1)
        prompt = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                                          device=device)}

        # one MoE layer at the prefill and the decode shape with any host
        # synchronisation raising (after a warm-up call)
        first_moe = next(i for i in range(n_layers) if cfg.mlp_kind_at(i % cfg.cycle_len) == "moe")
        lp = model.tree()["layers"][first_moe]["mlp"]
        x = torch.randn(batch, prompt_len, cfg.d_model, generator=g, device=device).to(torch.bfloat16)
        sync_error = None
        with torch.inference_mode():
            moe_apply(lp, x, cfg)
            moe_apply(lp, x[:, :1], cfg)
            if on_card:
                torch.cuda.synchronize()
                try:
                    with sync_errors()():
                        moe_apply(lp, x, cfg)
                        moe_apply(lp, x[:, :1], cfg)
                except RuntimeError as e:
                    sync_error = str(e)[:300]
        if sync_error is not None:
            fail("serve_moe", f"{name}: a host synchronisation in moe_apply", error=sync_error)
        del x

        generate(model, cfg, prompt, 1, flags=kernel_flags)  # warm-up: cuBLAS handles, allocator
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        FK.reset_launches()
        SK.reset_launches()
        NK.rmsnorm_cuda.launches = 0
        t0 = time.perf_counter()
        tokens, last = generate(model, cfg, prompt, new, flags=kernel_flags)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash": FK.flash_attention_cuda.launches, "ssd": SK.ssd_cuda.launches,
                    "rmsnorm": NK.rmsnorm_cuda.launches}
        routes = {"flash": dict(FK.launches_by_route), "ssd": dict(SK.launches_by_route)}
        peak = torch.cuda.max_memory_allocated() if on_card else None

        walls = []
        for _ in range(3):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, first = generate(model, cfg, prompt, 0, max_len=prompt_len + new, flags=kernel_flags)
            if on_card:
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        prefill_ms = sorted(walls)[1]
        decode_ms = (wall * 1e3 - prefill_ms) / new
        prof = {
            "prefill": device_profile(lambda: generate(
                model, cfg, prompt, 0, max_len=prompt_len + new, flags=kernel_flags)),
            "prefill_and_4_steps": device_profile(lambda: generate(
                model, cfg, prompt, 4, max_len=prompt_len + new, flags=kernel_flags)),
        } if profile else None
        with torch.inference_mode():
            cache = extend_cache(cfg, make_prefill_step(cfg, kernel_flags)(model, prompt)[1],
                                 prompt_len + new)
        cache_devices = sorted({str(t.device) for c in cache for t in c.values()})
        bound_ms, bound_bytes = decode_bound_ms(model, cfg, cache, batch)
        del cache
        want = moe_want_launches(cfg, 1 + new)
        summary = dict(
            model=name, layers=n_layers, held_layers=held,
            reduced={"n_layers": [ARCHS[name].n_layers, n_layers]} if name in ARCHS else None,
            d_model=cfg.d_model, experts=cfg.n_experts, top_k=cfg.top_k, expert_d_ff=cfg.moe_d_ff,
            params=n_params, param_counts_total=cfg.param_counts()["total"],
            capacity={"prefill": capacity(batch * prompt_len, cfg), "decode": capacity(batch, cfg)},
            batch=batch, prompt=prompt_len, new_tokens=new, allocated_before=allocated_before,
            init_s=init_s, wall_s=wall, tokens_per_s=batch * new / wall, prefill_ms=prefill_ms,
            prefill_ms_runs=walls, decode_ms_per_step=decode_ms, decode_bound_ms=bound_ms,
            decode_bound_bytes=bound_bytes, decode_bound_share=bound_ms / decode_ms,
            max_memory_allocated=peak, launches=launches, want_launches=want, routes=routes,
            sync_free=on_card, params_device=str(model.device), cache_devices=cache_devices,
            card=card, profile=prof,
        )
        if on_card:
            if model.device.type != "cuda" or cache_devices != ["cuda:0"]:
                fail("serve_moe", "the model or its cache is not on the card", **summary)
            if launches != want:
                fail("serve_moe", "kernel launches differ from the count the stack makes", **summary)
            if (routes["flash"]["tensor_cores"] != want["flash"]
                    or routes["ssd"]["tensor_cores"] != want["ssd"]):
                fail("serve_moe", "flash or SSD launches off the tensor-core route", **summary)
        finite = all(bool(torch.isfinite(t).all()) for t in (last, first))
        valid = tokens.shape == (batch, new) and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
        if not (finite and valid):
            fail("serve_moe", "non-finite logits or invalid token ids", finite=finite, valid=valid,
                 **summary)

        # the kernel path against the plain path on the same weights: each
        # layer alone from the same input (the bar on the tokens routed
        # alike held; every MoE layer's flips held where ``held``, else
        # reported: 128 experts top-8 sit closer at the boundary); then end
        # to end, where a flip upstream reaches every later position of its
        # sequence and flips near-ties there, so the share compounds with
        # depth: the first ``held`` layers held (flips at every MoE layer,
        # the bar where every token up to the position was routed alike),
        # all the layers reported
        layerwise = moe_layer_compare(model, cfg, prompt, kernel_flags)
        compare = {"all": moe_path_compare(model, cfg, prompt, kernel_flags, n_layers)}
        if 0 < held < n_layers:
            compare["held"] = moe_path_compare(model, cfg, prompt, kernel_flags, held)
        elif held:
            compare["held"] = compare["all"]
        summary.update(layerwise=layerwise, plain=compare,
                       bar={"atol": SERVE_ATOL, "rtol": SERVE_RTOL}, flip_max=MOE_FLIP_MAX,
                       seconds=time.perf_counter() - t_phase)
        if held and max(r.get("set", 0.0) for r in layerwise) > MOE_FLIP_MAX:
            fail("serve_moe", f"{name}: a layer alone flips the routing of more than "
                 f"{MOE_FLIP_MAX} of its tokens", **summary)
        if not all(r["within_bar_routed_alike"] for r in layerwise):
            fail("serve_moe", f"{name}: a layer's kernel path disagrees with its plain path on "
                 "tokens routed alike", **summary)
        if held and compare["held"]["max_set_flip"] > MOE_FLIP_MAX:
            fail("serve_moe", f"{name}: routing flips between the kernel and the plain path "
                 f"above {MOE_FLIP_MAX}", **summary)
        if held and not compare["held"]["within_bar_clean"]:
            fail("serve_moe", f"{name}: the kernel path disagrees with the plain path where "
                 "every token up to the position was routed alike", **summary)
        emit("serve_moe", ok=True, **summary)
        out[name] = launches
        del model, lp, tokens, last, first, prompt
        if on_card:
            torch.cuda.empty_cache()
    return out


# ---- the training path: flash's Function under autograd, Qwen3-1.7B training ----
FLASH_GRAD_SHAPES = (  # (b, s, h, kh, dh, dtype): the train and the train_moe shape (Qwen3-MoE's
    # 64:4, a GQA group of 16), a CUDA-core f32, a reduced bf16
    (4, 2048, 16, 8, 128, "bfloat16"), (2, 2048, 64, 4, 128, "bfloat16"), (2, 1024, 8, 4, 64, "float32"),
    (2, 256, 4, 2, 32, "bfloat16"))
LSE_TOL = 1e-5  # max|kernel - plain| / max|plain|: both take the lse in f32 from the same scores
TRAIN = dict(seq=2048, batch=4, steps=8, save_every=3, fail_at=5, lr=1e-3)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_PARAM_LR = 2e-2, 5e-2, 2.5  # card vs plain, one step
# card vs plain, one step: each leaf's gradient, ‖Δg‖ / ‖g‖ (step_vs_plain). bf16 rounding, and
# in train_moe the tokens routed otherwise, move every leaf by a few % (PERF.md §6); an
# attention or norm output that is wrong moves the leaves behind it by its own error
TRAIN_GRAD_RTOL = 0.1


def rel_to_max(got, want) -> float:
    """max |got - want| / max |want|."""
    return ((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30)).item()


def flash_bwd_bound(b, h, kh, s, dh, itemsize) -> tuple:
    """Least time for the flash backward (not a TPU kernel: a yardstick for
    the plain one): q, k, v, out and dout read once, the f32 lse read once,
    dq, dk, dv written once, over HBM bandwidth; five causal products (S
    recomputed, dV, dP, dK, dQ: 10·Dh operations per query-key pair) over
    the bf16 peak."""
    nbytes = itemsize * (3 * b * h * s * dh + 2 * b * kh * s * dh) + 4 * b * h * s
    nbytes += itemsize * (b * h * s * dh + 2 * b * kh * s * dh)
    ops = 10.0 * b * h * dh * s * (s + 1) / 2
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_grad_phase(card: str) -> dict:
    """Phase ``flash_grad``: ``ops.flash_attention`` under autograd (the
    kernel's forward with the row lse, the plain backward) against
    ``flash_ref.FlashAttentionRef`` (the plain forward and backward) on the
    card: out, lse, dq, dk, dv; then times. Returns the numbers the kernels
    line adds to flash's entry."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.flash_ref import FlashAttentionRef, _bwd_impl, _fwd_impl

    t0 = time.perf_counter()
    cases, failures = [], []
    for b, s, h, kh, dh, dt in FLASH_GRAD_SHAPES:
        dtype, tol = getattr(torch, dt), FLASH_TOL[dt]
        q, k, v = (x.transpose(1, 2).contiguous() for x in flash_inputs(b, h, kh, s, dh, dtype, seed=s))
        dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(7),
                           device="cuda").to(dtype)
        blocks = (min(512, s), min(512, s))
        xs, ys = ([x.clone().requires_grad_() for x in (q, k, v)] for _ in range(2))
        before = dict(FK.launches_by_route)
        out = flash_attention(*xs, True, *blocks)
        grads = torch.autograd.grad(out, xs, dout)
        took = [r for r in FK.ROUTES if FK.launches_by_route[r] != before[r]]
        want = FlashAttentionRef.apply(*ys, True, *blocks)
        want_grads = torch.autograd.grad(want, ys, dout)
        lse = torch.empty((b, s, h), dtype=torch.float32, device="cuda")
        FK.flash_attention_cuda(*(x.transpose(1, 2) for x in (q, k, v)), causal=True, lse=lse)
        want_lse = _fwd_impl(q, k, v, True, *blocks)[1]
        torch.cuda.synchronize()
        mag = want.double().abs()
        d = (out.double() - want.double()).abs()
        errs = {"out": rel_to_max(out, want), "lse": rel_to_max(lse.view_as(want_lse), want_lse)}
        errs.update({n: rel_to_max(g, w) for n, g, w in zip(("dq", "dk", "dv"), grads, want_grads)})
        case = dict(shape=[b, s, h, kh, dh], dtype=dt, route=took, out_max_abs_err=d.max().item(),
                    max_rel_err=errs, bar={"out": tol, "lse": LSE_TOL, "grads": tol},
                    grad_fn=type(out.grad_fn).__name__)
        ok = (bool((d <= tol + tol * mag).all()) and errs["lse"] <= LSE_TOL
              and all(errs[n] <= tol for n in ("dq", "dk", "dv"))
              and took == [FK.route(dtype, dh)] and out.grad_fn is not None)
        cases.append(case)
        if not ok:
            failures.append(case)
    if failures:
        fail("flash_grad", "the flash Function disagrees with the plain one on the card", failures=failures)

    # times at the serving and the training shape: the forward with and
    # without the lse, in turns; at the training shape also the plain
    # backward alone and SDPA's forward and backward
    timing = {}
    for s in (PREFILL["s"], TRAIN["seq"]):
        b, h, kh, dh = PREFILL["b"], PREFILL["h"], PREFILL["kh"], PREFILL["dh"]
        q, k, v = flash_inputs(b, h, kh, s, dh, torch.bfloat16, seed=s)
        lse = torch.empty((b, s, h), dtype=torch.float32, device="cuda")
        no_lse = lambda: FK.flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
        with_lse = lambda: FK.flash_attention_cuda(q, k, v, causal=True, lse=lse)  # noqa: E731
        runs = [cuda_time_ms(fn, 50) for fn in (no_lse, with_lse, with_lse, no_lse)]
        timing[s] = dict(ms=(runs[0] + runs[3]) / 2, ms_lse=(runs[1] + runs[2]) / 2, runs=runs)
    s = TRAIN["seq"]
    qm, km, vm = (x.transpose(1, 2).contiguous() for x in flash_inputs(4, 16, 8, s, 128, torch.bfloat16, 1))
    dout = torch.randn(qm.shape, device="cuda").to(torch.bfloat16)
    out, lse = _fwd_impl(qm, km, vm, True, 512, 512)
    bwd_ms = cuda_time_ms(lambda: _bwd_impl(qm, km, vm, out, lse, dout, True, 512, 512), 5)
    bwd_bound_ms, bwd_bound_by = flash_bwd_bound(4, 16, 8, s, 128, 2)
    xs = [x.clone().requires_grad_() for x in (qm, km, vm)]
    fwd_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(flash_attention(*xs, True, 512, 512), xs, dout), 5)
    qt = [x.transpose(1, 2).detach().requires_grad_() for x in (qm, km, vm)]
    sdpa = lambda: F.scaled_dot_product_attention(*qt, is_causal=True, enable_gqa=True)  # noqa: E731
    sdpa_fwd_ms = cuda_time_ms(sdpa, 20)
    o = sdpa()
    dot = dout.transpose(1, 2)
    sdpa_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(o, qt, dot, retain_graph=True), 20)
    sdpa_fwd_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(sdpa(), qt, dot), 20)
    summary = dict(
        cases=cases, serve_shape=dict(PREFILL), train_shape=dict(PREFILL, s=s),
        fwd_ms=timing[PREFILL["s"]], fwd_ms_train=timing[s],
        lse_overhead_serve=timing[PREFILL["s"]]["ms_lse"] / timing[PREFILL["s"]]["ms"] - 1,
        plain_bwd_ms=bwd_ms, bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by, fwd_bwd_ms=fwd_bwd_ms, sdpa_fwd_ms=sdpa_fwd_ms, sdpa_bwd_ms=sdpa_bwd_ms,
        sdpa_fwd_bwd_ms=sdpa_fwd_bwd_ms, card=card, seconds=time.perf_counter() - t0)
    emit("flash_grad", ok=True, **summary)
    return dict(ms_lse=timing[PREFILL["s"]]["ms_lse"], ms_lse_train=timing[s]["ms_lse"],
                ms_train=timing[s]["ms"], library_ms_train_fwd_bwd=sdpa_fwd_bwd_ms,
                plain_bwd_ms=bwd_ms, bwd_bound_ms=bwd_bound_ms, library_bwd_ms=sdpa_bwd_ms,
                grad_max_rel_err=max(max(c["max_rel_err"].values()) for c in cases))


def flops_summary(cfg, batch: int, seq: int, step_s: float) -> dict:
    """Model FLOPs of one training step by the port's analytic model,
    ``roofline.analytic.model_flops`` (6 · active parameters · tokens plus
    the causal attention products), × 4/3 for ``remat="full"``, which
    re-runs the forward (every layer and, the CE chunks being checkpointed,
    the head) inside the backward; the share an untied embedding table
    adds (6 · V · D · tokens: a row gather that does no matrix arithmetic;
    0 where the table is the head's); and the share of the bf16 peak at
    ``step_s`` a step of each, with and without that lookup."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.roofline.analytic import model_flops

    flops = model_flops(cfg, ShapeConfig("train", seq, batch, "train"))
    lookup = 0 if cfg.tie_embeddings else 6 * cfg.vocab_size * cfg.d_model * batch * seq
    peak = step_s * PEAK_BF16_FLOPS
    return dict(
        model_flops_per_step=flops, model_flops_with_recompute=flops * 4 / 3,
        embed_lookup_flops=lookup, embed_lookup_share=lookup / flops,
        mfu=flops / peak, mfu_with_recompute=flops * 4 / 3 / peak,
        mfu_without_embed_lookup=(flops - lookup) / peak,
        mfu_with_recompute_without_embed_lookup=(flops - lookup) * 4 / 3 / peak)


def host_snapshot(state) -> dict:
    """A train state's parameters and first moments, copied to the host by
    name (a DTensor leaf as its full tensor): what :func:`step_vs_plain`
    holds, kept off the card while the plain step runs."""
    import torch

    from repro_torch.sharding.act import whole

    with torch.no_grad():
        return {"params": {n: whole(p.detach()).to("cpu", copy=True) for n, p in state["params"].named_parameters()},
                "m": {n: whole(t).to("cpu", copy=True) for n, t in state["opt"]["m"].items()}}


def step_vs_plain(kernel: dict, km: dict, plain: dict, pm: dict) -> tuple:
    """(summary, ok): one train step on the kernel path (``kernel``, a
    :func:`host_snapshot`, and its metrics ``km``) against the same step
    from the same state and batch on the plain path (its state ``plain``
    and metrics ``pm``). The loss and the global gradient norm are held at
    TRAIN_LOSS_RTOL and TRAIN_GNORM_RTOL; the gradients leaf by leaf. After
    one AdamW step from zero moments each leaf's first moment is (1 - b1) ·
    clip scale · its gradient, so ‖m_kernel - m_plain‖ / ‖m_plain‖ is that
    leaf's gradient error (the two clip scales differ as the global norms
    do): within TRAIN_GRAD_RTOL for every leaf, reported per leaf kind (the
    worst layer) beside the max-relative error. The parameters are
    reported and held at TRAIN_PARAM_LR · lr, a bound Adam's first step
    keeps by itself (each update is about lr · sign(g), so a flipped sign
    moves one element by 2 lr): it cannot tell a wrong gradient, the
    moments can."""
    import torch

    lr = float(km["lr"])
    loss_k, loss_p = float(km["loss"]), float(pm["loss"])
    gn_k, gn_p = float(km["grad_norm"]), float(pm["grad_norm"])
    param_err, kinds, worst = 0.0, {}, ("", 0.0)
    with torch.no_grad():
        for n, p in plain["params"].named_parameters():
            param_err = max(param_err, (kernel["params"][n].to(p.device) - p).abs().max().item())
            want = plain["opt"]["m"][n].double()
            d = kernel["m"][n].to(want.device).double() - want
            by_norm = (d.norm() / want.norm().clamp_min(1e-30)).item()
            by_max = (d.abs().max() / want.abs().max().clamp_min(1e-30)).item()
            kind = ".".join(n.split(".")[2:]) if n.startswith("layers.") else n  # the layer index dropped
            k = kinds.setdefault(kind, {"grad_rel_norm": 0.0, "grad_rel_max": 0.0})
            k["grad_rel_norm"], k["grad_rel_max"] = max(k["grad_rel_norm"], by_norm), max(k["grad_rel_max"], by_max)
            if by_norm > worst[1]:
                worst = (n, by_norm)
    summary = dict(
        loss_kernel=loss_k, loss_plain=loss_p, loss_rel=abs(loss_k - loss_p) / abs(loss_p),
        grad_norm_kernel=gn_k, grad_norm_plain=gn_p, grad_norm_rel=abs(gn_k - gn_p) / gn_p,
        grad_rel_norm_worst={"leaf": worst[0], "value": worst[1]}, grads_by_kind=kinds,
        lr=lr, max_param_diff=param_err, max_param_diff_over_lr=param_err / lr,
        bar={"loss_rtol": TRAIN_LOSS_RTOL, "grad_norm_rtol": TRAIN_GNORM_RTOL,
             "grad_rel_norm_per_leaf": TRAIN_GRAD_RTOL, "param_atol_lr": TRAIN_PARAM_LR})
    ok = (summary["loss_rel"] <= TRAIN_LOSS_RTOL and summary["grad_norm_rel"] <= TRAIN_GNORM_RTOL
          and worst[1] <= TRAIN_GRAD_RTOL and param_err <= TRAIN_PARAM_LR * lr)
    return summary, ok


def train_phase(card: str, cfg=None, device="cuda", **overrides) -> dict:
    """Phase ``train``: Qwen3-1.7B (28 layers, width 2048) trained on the
    card through the flash and RMSNorm kernels under autograd. ``cfg``,
    ``device`` and ``overrides`` of :data:`TRAIN` exist to rehearse the
    phase on the CPU at a reduced size (no kernel launches are counted
    there). Returns the launch counts of one step, with the step wall,
    tokens/s and peak memory (``train_mesh`` reports its own beside them)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.models.model import RunFlags
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.health import Supervisor
    from repro_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    run = dict(TRAIN, **overrides)
    cfg = cfg or get_config("qwen3-1.7b")
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    opt = AdamWConfig(peak_lr=run["lr"], warmup_steps=2, total_steps=run["steps"])
    kernel_flags = RunFlags(attn_impl="kernel", norm_impl="kernel", remat="full")
    plain_flags = RunFlags(attn_impl="blockwise", norm_impl="reference", remat="full")
    data = lambda: for_model(cfg, seq_len=run["seq"], global_batch=run["batch"], seed=0)  # noqa: E731
    fresh = lambda: init_train_state(cfg, seed=0, device=device)  # noqa: E731

    # ---- one step on the kernel path, its launches counted; the same step
    # from the same state and batch on the plain path ------------------------
    batch = data().next_batch()
    state = fresh()
    n_params = sum(p.numel() for p in state["params"].parameters())
    sync()
    FK.reset_launches()
    rmsnorm_cuda.launches = 0
    t0 = time.perf_counter()
    state, km = make_train_step(cfg, kernel_flags, opt)(state, batch)
    sync()
    first_step_s = time.perf_counter() - t0
    launches = {"flash": FK.flash_attention_cuda.launches, "flash_by_route": dict(FK.launches_by_route),
                "rmsnorm": rmsnorm_cuda.launches}
    want = {"flash": cfg.n_layers * 2, "rmsnorm": cfg.n_layers * 4 * 2 + 1} if on_card else None
    kernel = host_snapshot(state)
    del state
    plain, pm = make_train_step(cfg, plain_flags, opt)(fresh(), batch)
    sync()
    vs_plain, vs_ok = step_vs_plain(kernel, km, plain, pm)
    del plain, kernel

    # ---- 8 steps under the Supervisor with an async checkpoint manager, then
    # the same run with a fault injected once at step 5 -----------------------
    def supervised(inject: bool):
        tmp = tempfile.mkdtemp(prefix="train_ckpt_")
        try:
            state = fresh()
            target = state
            ckpt = CheckpointManager(tmp, keep_n=1, async_save=True)
            sup = Supervisor(ckpt, data(), save_every=run["save_every"])
            step_fn = make_train_step(cfg, kernel_flags, opt)
            trace, walls, injected = {}, [], []

            def step(s, b):
                if inject and not injected and int(s["step"]) == run["fail_at"] - 1:
                    injected.append(int(s["step"]) + 1)
                    raise RuntimeError(f"injected fault at step {run['fail_at']}")
                sync()
                t = time.perf_counter()
                out = step_fn(s, b)
                sync()
                walls.append(time.perf_counter() - t)
                return out

            def on_metrics(i, m):
                trace[i] = (m["loss"].item(), m["grad_norm"].item())

            sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            state = sup.run(state, step, run["steps"], restore_fn=lambda: ckpt.restore(target),
                            on_metrics=on_metrics)
            sync()
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() if on_card else None
            return state, dict(trace=trace, walls=walls, wall_s=wall, recoveries=sup.recoveries,
                               injected=len(injected), peak=peak, stragglers=len(sup.monitor.flagged))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    det = (torch.are_deterministic_algorithms_enabled(), torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False  # the kernels' outputs are written whole
    try:
        state, clean = supervised(inject=False)
        del state
        state, faulty = supervised(inject=True)
    finally:
        torch.use_deterministic_algorithms(det[0])
        torch.utils.deterministic.fill_uninitialized_memory = det[1]
    steps = sorted(clean["trace"])
    losses = [clean["trace"][i][0] for i in steps]
    bitwise = [faulty["trace"].get(i) == clean["trace"][i] for i in steps]
    walls = sorted(clean["walls"][1:])
    step_s = walls[len(walls) // 2]

    profile = None
    if on_card:  # where a step's time goes: one more step under the profiler
        b = data().next_batch()
        step_fn = make_train_step(cfg, kernel_flags, opt)
        profile = device_profile(lambda: step_fn(state, b)[1]["loss"].item())
    del state

    summary = dict(
        model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, params=n_params, batch=run["batch"],
        seq=run["seq"], steps=run["steps"], remat="full", flags="attn kernel, norm kernel",
        launches_one_step=launches, want_launches=want, vs_plain=vs_plain,
        step_wall_s=step_s, step_walls_s=clean["walls"], first_step_s=first_step_s,
        tokens_per_s=run["batch"] * run["seq"] / step_s, supervised_wall_s=clean["wall_s"],
        max_memory_allocated=clean["peak"], losses=losses,
        grad_norms=[clean["trace"][i][1] for i in steps], **flops_summary(cfg, run["batch"], run["seq"], step_s),
        recovery=dict(injected=faulty["injected"], recoveries=faulty["recoveries"],
                      bitwise_equal_steps=sum(bitwise), steps=len(steps), deterministic_algorithms=True,
                      wall_s=faulty["wall_s"]),
        stragglers=clean["stragglers"], profile=profile, card=card, seconds=time.perf_counter() - t_phase)
    why = []
    if want and (launches["flash"] != want["flash"] or launches["rmsnorm"] != want["rmsnorm"]
                 or launches["flash_by_route"]["tensor_cores"] != want["flash"]):
        why.append(f"launches {launches}, want {want} (flash all on the tensor-core route)")
    if not vs_ok:
        why.append("the kernel path's step is off the plain path's")
    if not all(math.isfinite(x) for x in losses) or len(losses) != run["steps"] or losses[-1] >= losses[0]:
        why.append("losses not finite, or the last not below the first")
    if faulty["injected"] != 1 or faulty["recoveries"] != 1:
        why.append(f"{faulty['recoveries']} recoveries for {faulty['injected']} injected faults")
    if not all(bitwise):
        why.append("the recovered run's loss trace differs from the uninterrupted run's")
    if why:
        fail("train", "; ".join(why), **summary)
    emit("train", ok=True, **summary)
    return dict(launches, step_wall_s=step_s, tokens_per_s=summary["tokens_per_s"],
                max_memory_allocated=clean["peak"])


# Qwen3-MoE cut from 94 layers to 1; the kernel-vs-plain step at 64 experts: at
# 128 the plain path's blockwise attention backward needs more than the card
# has left beside the 128-expert f32 state (measured, PERF.md)
TRAIN_MOE = dict(seq=2048, batch=2, steps=6, lr=1e-3, layers=1, compare_experts=64)


def moe_sync_check(cfg, batch: int, seq: int, device) -> str | None:
    """One full-width MoE layer, forward and backward, at the train step's
    shape with any host synchronisation raising (after a warm-up call):
    None, or the error. Its own seeded weights (bf16 experts, f32 router)
    and input, freed on return."""
    import torch

    from repro_torch.models.moe import moe_apply, moe_init

    g = torch.Generator(device=device).manual_seed(2)

    def normal(shape, scale, dt):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dt)

    params = {k: v.requires_grad_() for k, v in moe_init(normal, cfg, torch.bfloat16, device).items()}
    x = torch.randn(batch, seq, cfg.d_model, generator=g, device=device).to(torch.bfloat16).requires_grad_()
    leaves = [x] + list(params.values())

    def fwd_bwd():
        y, aux = moe_apply(params, x, cfg)
        return torch.autograd.grad(y.float().square().mean() + aux, leaves)

    fwd_bwd()
    torch.cuda.synchronize()
    try:
        with sync_errors()():
            grads = fwd_bwd()
        torch.cuda.synchronize()
        return None if all(gr is not None for gr in grads) else "a leaf got no gradient"
    except RuntimeError as e:
        return str(e)[:300]


def determinism_probe(cfg, batch: int, seq: int, device) -> dict:
    """Under ``torch.use_deterministic_algorithms(True)``: each of the MoE
    layer's three order-sensitive CUDA ops at the train step's shape — the
    dispatch ``index_add``, the position ``cumsum`` of the (T·k, E) one-hot
    and the combine's gather backward (a scatter-add into the (E·C, D)
    buffer) — as "ok" or the error it raises, verbatim."""
    import torch

    from repro_torch.models.moe import capacity

    t, k, e, d = batch * seq, cfg.top_k, cfg.n_experts, cfg.d_model
    c = capacity(t, cfg)
    g = torch.Generator(device=device).manual_seed(3)
    flat_e = torch.randint(0, e, (t * k,), generator=g, device=device)
    slot = flat_e * c + torch.randint(0, c, (t * k,), generator=g, device=device)
    rows = torch.randn(t * k, d, generator=g, device=device).to(torch.bfloat16)
    onehot = (flat_e[:, None] == torch.arange(e, device=device)).to(torch.int32)
    h = torch.randn(e * c, d, generator=g, device=device).to(torch.bfloat16).requires_grad_()
    ops = {
        "index_add": lambda: torch.zeros(e * c, d, dtype=torch.bfloat16, device=device).index_add(0, slot, rows),
        "cumsum": lambda: torch.cumsum(onehot, 0),
        "gather_backward": lambda: torch.autograd.grad(h[slot].float().sum(), h),
    }
    out = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for name, fn in ops.items():
            try:
                fn()
                torch.cuda.synchronize()
                out[name] = "ok"
            except RuntimeError as err:
                out[name] = str(err).splitlines()[0][:300]
    finally:
        torch.use_deterministic_algorithms(was)
    return out


def train_moe_phase(card: str, cfg=None, device="cuda", **overrides) -> dict:
    """Phase ``train_moe``: Qwen3-MoE (one layer of 94 at full width: all 128
    experts, top-8, 64:4 GQA, qk-norm; untied 151,936-token embedding and
    head) trained on the card through the flash and RMSNorm kernels under
    autograd, ``microbatches=1``; the kernel path against the plain path at
    ``compare_experts``. ``cfg``, ``device`` and ``overrides`` of
    :data:`TRAIN_MOE` exist to rehearse the phase on the CPU at a reduced
    size (no launches are counted and no sync is checked there). Returns
    the launch counts of one step."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.models.model import RunFlags
    from repro_torch.models.moe import capacity, record_routing
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    run = dict(TRAIN_MOE, **overrides)
    cfg = cfg or dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=run["layers"])
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def free():
        if on_card:
            torch.cuda.empty_cache()

    free()
    allocated_before = torch.cuda.memory_allocated() if on_card else None
    opt = AdamWConfig(peak_lr=run["lr"], warmup_steps=2, total_steps=run["steps"])
    kernel_flags = RunFlags(attn_impl="kernel", norm_impl="kernel", remat="full")
    plain_flags = RunFlags(attn_impl="blockwise", norm_impl="reference", remat="full")
    data = lambda c: for_model(c, seq_len=run["seq"], global_batch=run["batch"], seed=0)  # noqa: E731
    n_attn = sum(cfg.block_kinds[i % cfg.cycle_len] == "attn" for i in range(cfg.n_layers))
    n_moe = sum(cfg.mlp_kind_at(i % cfg.cycle_len) == "moe" for i in range(cfg.n_layers))
    want = {"flash": 2 * n_attn, "rmsnorm": cfg.n_layers * 4 * 2 + 1} if on_card else None

    # ---- moe_apply's forward and backward free of host syncs --------------
    sync_error = moe_sync_check(cfg, run["batch"], run["seq"], device) if on_card else None
    if sync_error is not None:
        fail("train_moe", "a host synchronisation in moe_apply's forward or backward", error=sync_error)

    # ---- steps in a plain loop (no Supervisor, no checkpoint); the first
    # with its launches counted (zeroed just before, read just after) -------
    state = init_train_state(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in state["params"].parameters())
    stream = data(cfg)
    step_fn = make_train_step(cfg, kernel_flags, opt)
    losses, walls, launches = [], [], None
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for i in range(run["steps"]):
        b = stream.next_batch()
        sync()
        if i == 0:
            FK.reset_launches()
            rmsnorm_cuda.launches = 0
        t = time.perf_counter()
        state, m = step_fn(state, b)
        sync()
        walls.append(time.perf_counter() - t)
        if i == 0:
            launches = {"flash": FK.flash_attention_cuda.launches,
                        "flash_by_route": dict(FK.launches_by_route), "rmsnorm": rmsnorm_cuda.launches}
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() if on_card else None
    step_s = sorted(walls[1:])[len(walls[1:]) // 2]

    profile = determinism = deterministic_step = None
    if on_card:  # where a step's time goes; then the determinism probe
        b = stream.next_batch()
        profile = device_profile(lambda: step_fn(state, b)[1]["loss"].item())
        determinism = determinism_probe(cfg, run["batch"], run["seq"], device)
        torch.use_deterministic_algorithms(True)
        try:
            step_fn(state, stream.next_batch())[1]["loss"].item()
            deterministic_step = "ok"
        except RuntimeError as err:
            deterministic_step = str(err).splitlines()[0][:300]
        finally:
            torch.use_deterministic_algorithms(False)
    del state, m, step_fn
    free()

    # ---- end to end: one step on the kernel path and the same step from the
    # same state and batch on the plain path, at compare_experts (so its
    # routing flips are those of that model, not of the timed one; the
    # kernels themselves are held at this phase's shapes in flash_grad and
    # rmsnorm_parity); the kernel step's parameters and moments moved to the
    # host before the plain step's state is made --------------------------
    ccfg = dataclasses.replace(cfg, n_experts=run["compare_experts"])
    batch = data(ccfg).next_batch()
    with record_routing() as kernel_routes:
        state, km = make_train_step(ccfg, kernel_flags, opt)(init_train_state(ccfg, seed=0, device=device), batch)
    kernel = host_snapshot(state)
    km = {k: float(v) for k, v in km.items()}
    del state
    free()
    with record_routing() as plain_routes:
        plain, pm = make_train_step(ccfg, plain_flags, opt)(init_train_state(ccfg, seed=0, device=device), batch)
    sync()
    vs_plain, vs_ok = step_vs_plain(kernel, km, plain, pm)
    # each MoE call's forward: remat records the recomputes after them
    flips, _ = routing_flips(kernel_routes[:n_moe], plain_routes[:n_moe], ccfg.n_experts)
    vs_plain = dict(
        scope=f"end to end, at {ccfg.n_experts} experts: routing_flips and every number here are that "
              f"model's, not the timed {cfg.n_experts}-expert one's",
        experts=ccfg.n_experts, capacity=capacity(run["batch"] * run["seq"], ccfg),
        aux_kernel=km["aux_loss"], aux_plain=float(pm["aux_loss"]), routing_flips=flips, **vs_plain)
    del plain, kernel, kernel_routes, plain_routes
    free()

    summary = dict(
        model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, experts=cfg.n_experts, top_k=cfg.top_k,
        capacity=capacity(run["batch"] * run["seq"], cfg), params=n_params, batch=run["batch"],
        seq=run["seq"], steps=run["steps"], microbatches=1, remat="full", flags="attn kernel, norm kernel",
        allocated_before=allocated_before, sync_free_moe_apply=sync_error is None if on_card else None,
        launches_one_step=launches, want_launches=want, vs_plain=vs_plain,
        step_wall_s=step_s, step_walls_s=walls, tokens_per_s=run["batch"] * run["seq"] / step_s,
        max_memory_allocated=peak, losses=losses, **flops_summary(cfg, run["batch"], run["seq"], step_s),
        profile=profile, deterministic_ops=determinism, deterministic_step=deterministic_step,
        card=card, seconds=time.perf_counter() - t_phase)
    why = []
    if want and (launches["flash"] != want["flash"] or launches["rmsnorm"] != want["rmsnorm"]
                 or launches["flash_by_route"]["tensor_cores"] != want["flash"]):
        why.append(f"launches {launches}, want {want} (flash all on the tensor-core route)")
    if not vs_ok:
        why.append("the kernel path's step is off the plain path's")
    if not all(math.isfinite(x) for x in losses) or len(losses) != run["steps"] or losses[-1] >= losses[0]:
        why.append("losses not finite, or the last not below the first")
    if why:
        fail("train_moe", "; ".join(why), **summary)
    emit("train_moe", ok=True, **summary)
    return launches


# the mesh phase: Qwen3-1.7B at the train phase's shape on a (1, 1) mesh; one
# full-width Qwen3-MoE MoE layer in f32, dropless as the reference's own
# shard_map test (capacity factor 8)
TRAIN_MESH = dict(seq=2048, batch=4, steps=3, lr=1e-3, moe_batch=2, moe_seq=2048, moe_cf=8.0)
MOE_SM_TOL = 1e-5  # shard_map vs dense MoE at axis sizes of 1: the reference's bar


def state_leaves(state):
    """(name, tensor) of every leaf of a train state."""
    yield from (("params." + n, p) for n, p in state["params"].named_parameters())
    for key in ("m", "v"):
        yield from ((f"opt.{key}.{n}", t) for n, t in state["opt"][key].items())
    yield "opt.count", state["opt"]["count"]
    yield "step", state["step"]


def collective_counts(fn):
    """(fn(), {category: collective ops}, {op name: calls}) for every
    collective ``fn`` dispatches, DTensor's own redistributions included
    (``roofline.hlo.StepCounter``; ``wait_tensor`` is not counted)."""
    from repro_torch.roofline.hlo import StepCounter
    from repro_torch.roofline.hlo import collective_counts as by_category

    with StepCounter() as c:
        out = fn()
    return out, by_category(c), dict(c.ops)


def mesh_moe_check(cfg, mesh, batch: int, seq: int, device, on_card: bool) -> dict:
    """One MoE layer of ``cfg`` in f32 at (batch, seq): ``moe_apply_shard_map``
    on ``mesh`` against ``moe_apply`` on the same weights and input, forward
    and backward (loss mean(y²) + aux); on the card the shard_map pass runs
    under sync-debug "error" after a warm-up, with its collectives counted
    by direction. Its own seeded weights, freed on return."""
    import contextlib

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.models.moe_shard_map import moe_apply_shard_map
    from repro_torch.sharding.act import activation_rules, replicated
    from repro_torch.sharding.rules import default_rules

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    g = torch.Generator(device=device).manual_seed(3)

    def normal(shape, scale, dt):
        return (torch.randn(shape, generator=g, device=device) * scale).to(dt)

    params = {k: v.requires_grad_() for k, v in moe_init(normal, cfg, torch.float32, device).items()}
    x = torch.randn(batch, seq, cfg.d_model, generator=g, device=device).requires_grad_()
    leaves = [x] + list(params.values())
    rules = default_rules(cfg, ShapeConfig("train", seq, batch, "train"), mesh)

    def dense():
        y, aux = moe_apply(params, x, cfg)
        return y.detach(), aux.detach(), torch.autograd.grad(y.square().mean() + aux, leaves)

    def sharded():
        with activation_rules(rules, mesh):
            y, aux = moe_apply_shard_map({k: replicated(v, mesh) for k, v in params.items()},
                                         replicated(x, mesh), cfg, mesh, rules)
            loss = (y.square().mean() + aux).full_tensor()
            fwd = (y.full_tensor().detach(), aux.full_tensor().detach())
        return fwd, loss

    sync()
    t = time.perf_counter()
    y_d, aux_d, g_d = dense()
    sync()
    dense_s = time.perf_counter() - t
    sharded()[1].backward()  # warm-up: the NCCL communicators come up here
    for p in leaves:
        p.grad = None
    sync()
    t = time.perf_counter()
    try:
        with sync_errors()() if on_card else contextlib.nullcontext():
            (fwd, loss), fwd_cat, fwd_ops = collective_counts(sharded)
            _, bwd_cat, bwd_ops = collective_counts(lambda: loss.backward())
        sync()
    except RuntimeError as e:
        return {"error": str(e)[:300]}
    sharded_s = time.perf_counter() - t
    (y_s, aux_s), g_s = fwd, [p.grad for p in leaves]
    names = ["x"] + list(params)
    grads = {n: rel_to_max(a, b) for n, a, b in zip(names, g_s, g_d)}
    exchanges = {"forward": fwd_cat["all-to-all"], "backward": bwd_cat["all-to-all"]}
    out = dict(
        y_err=((y_s - y_d).abs().max() / y_d.abs().max().clamp_min(1.0)).item(),
        aux_err=abs(aux_s.item() - aux_d.item()), aux=aux_s.item(), grad_rel_to_max=grads,
        grads_finite=all(bool(torch.isfinite(gr).all()) for gr in g_s), exchanges=exchanges,
        collectives_forward=fwd_cat, collectives_backward=bwd_cat, collective_ops_forward=fwd_ops,
        collective_ops_backward=bwd_ops, sync_free=on_card,
        dense_fwd_bwd_s=dense_s, shard_map_fwd_bwd_s=sharded_s, tol=MOE_SM_TOL)
    del params, x, leaves, g_d, g_s
    return out


def train_mesh_phase(card: str, cfg=None, moe_cfg=None, device="cuda", beside=None, **overrides) -> dict:
    """Phase ``train_mesh``: the sharded training path on a (1, 1) ("data",
    "model") mesh of one process (NCCL on the card, gloo on the CPU): (a)
    Qwen3-1.7B at the train phase's shape, its state placed by
    ``runtime.elastic.state_shardings`` and its steps run under
    ``activation_rules`` through the flash and RMSNorm kernels (each on its
    device's shards, via ``local_map``): launches a step, the first step
    against the unsharded kernel step from the same state and batch at the
    train phase's bars (and whether the two are equal bit for bit), step
    wall, tokens/s and peak memory, and a checkpoint written from the mesh
    state and restored with its shardings, bit for bit; (b) one full-width
    Qwen3-MoE MoE layer through ``moe_apply_shard_map`` against
    ``moe_apply`` (:func:`mesh_moe_check`). ``beside`` is the train phase's
    return (its step wall, tokens/s and peak from the same call), reported
    beside this phase's. ``cfg``, ``moe_cfg``, ``device`` and ``overrides``
    of :data:`TRAIN_MESH` exist to rehearse the phase on the CPU at a reduced
    size. The process group is destroyed at the end. Returns the launch
    counts of one mesh step."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.model import RunFlags
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.elastic import reshard_state, state_shardings
    from repro_torch.sharding.act import activation_rules, whole
    from repro_torch.sharding.rules import default_rules
    from repro_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    run = dict(TRAIN_MESH, **overrides)
    cfg = cfg or get_config("qwen3-1.7b")
    moe_cfg = dataclasses.replace(moe_cfg or get_config("qwen3-moe-235b-a22b"), capacity_factor=run["moe_cf"])
    kind = torch.device(device).type
    on_card = kind == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    init_process_group(kind)
    try:
        mesh = make_host_mesh(1, kind)
        opt = AdamWConfig(peak_lr=run["lr"], warmup_steps=2, total_steps=run["steps"])
        flags = RunFlags(attn_impl="kernel", norm_impl="kernel", remat="full")
        shape = ShapeConfig("train", run["seq"], run["batch"], "train")
        rules = default_rules(cfg, shape, mesh)
        data = for_model(cfg, seq_len=run["seq"], global_batch=run["batch"], seed=0)
        batches = [data.next_batch() for _ in range(run["steps"])]

        # ---- (a) the mesh steps ------------------------------------------------
        state = init_train_state(cfg, seed=0, device=device)
        shardings = state_shardings(cfg, shape, mesh, state, rules)
        state = reshard_state(state, shardings)
        placed = all(isinstance(t, DTensor) for _, t in state_leaves(state))
        step_fn = make_train_step(cfg, flags, opt)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        with activation_rules(rules, mesh):
            for i, b in enumerate(batches):
                sync()
                FK.reset_launches()
                rmsnorm_cuda.launches = 0
                t = time.perf_counter()
                state, m = step_fn(state, b)
                sync()
                walls.append(time.perf_counter() - t)
                losses.append(float(m["loss"]))
                if i == 0:
                    launches = {"flash": FK.flash_attention_cuda.launches,
                                "flash_by_route": dict(FK.launches_by_route),
                                "rmsnorm": rmsnorm_cuda.launches}
                    first = host_snapshot(state)
                    first_m = {k: float(v) for k, v in m.items()}
            peak = torch.cuda.max_memory_allocated() if on_card else None
            # where a mesh step's time goes: one more step under the profiler
            b = data.next_batch()
            profile = device_profile(lambda: step_fn(state, b)[1]["loss"].item()) if on_card else None
        want = {"flash": cfg.n_layers * 2, "rmsnorm": cfg.n_layers * 4 * 2 + 1} if on_card else None

        # ---- a checkpoint from the mesh run, restored with its shardings ------
        tmp = tempfile.mkdtemp(prefix="train_mesh_ckpt_")
        try:
            ckpt = CheckpointManager(tmp, keep_n=1, async_save=False)
            t = time.perf_counter()
            ckpt.save(run["steps"], state)
            ckpt.wait()
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            restored, meta = ckpt.restore(state, shardings=shardings)
            sync()
            restore_s = time.perf_counter() - t
            saved = dict(state_leaves(state))
            differ = [n for n, v in state_leaves(restored) if not torch.equal(whole(v), whole(saved[n]))]
            same_placements = all(isinstance(v, DTensor) and v.placements == saved[n].placements
                                  for n, v in state_leaves(restored))
            n_leaves = len(saved)
            del restored, saved
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del state
        if on_card:
            torch.cuda.empty_cache()

        # ---- the unsharded kernel step from the same state and batch -------------
        plain, pm = make_train_step(cfg, flags, opt)(init_train_state(cfg, seed=0, device=device), batches[0])
        sync()
        vs_plain, vs_ok = step_vs_plain(first, first_m, plain, pm)
        n_params = len(first["params"])
        with torch.no_grad():
            bitwise = sum(torch.equal(first["params"][n], p.detach().to("cpu"))
                          and torch.equal(first["m"][n], plain["opt"]["m"][n].to("cpu"))
                          for n, p in plain["params"].named_parameters())
        loss_bitwise = first_m["loss"] == float(pm["loss"])
        del plain, first
        if on_card:
            torch.cuda.empty_cache()

        # ---- (b) the shard_map MoE layer -------------------------------------------
        moe = mesh_moe_check(moe_cfg, mesh, run["moe_batch"], run["moe_seq"], device, on_card)
    finally:
        dist.destroy_process_group()

    step_s = sorted(walls[1:])[len(walls[1:]) // 2] if len(walls) > 1 else walls[0]
    summary = dict(
        model=cfg.name, layers=cfg.n_layers, mesh=[1, 1], batch=run["batch"], seq=run["seq"],
        steps=run["steps"], state_placed=placed, launches_one_step=launches, want_launches=want,
        vs_unsharded=vs_plain, unsharded_bitwise_equal_leaves=bitwise, leaves=n_params,
        loss_bitwise=loss_bitwise, step_wall_s=step_s, step_walls_s=walls,
        tokens_per_s=run["batch"] * run["seq"] / step_s, max_memory_allocated=peak, losses=losses,
        profile=profile, train_same_call={k: beside[k] for k in ("step_wall_s", "tokens_per_s", "max_memory_allocated")}
        if beside else None,
        checkpoint=dict(leaves=n_leaves, differ=differ, same_placements=same_placements,
                        save_s=save_s, restore_s=restore_s),
        moe=dict(model=moe_cfg.name, experts=moe_cfg.n_experts, top_k=moe_cfg.top_k,
                 d_model=moe_cfg.d_model, d_ff=moe_cfg.moe_d_ff, capacity_factor=moe_cfg.capacity_factor,
                 batch=run["moe_batch"], seq=run["moe_seq"], dtype="float32", **moe),
        card=card, seconds=time.perf_counter() - t_phase)
    why = []
    if not placed:
        why.append("a state leaf is not a DTensor")
    if want and (launches["flash"] != want["flash"] or launches["rmsnorm"] != want["rmsnorm"]
                 or launches["flash_by_route"]["tensor_cores"] != want["flash"]):
        why.append(f"launches {launches}, want {want} (flash all on the tensor-core route)")
    if not vs_ok:
        why.append("the mesh step is off the unsharded step")
    if differ or not same_placements:
        why.append(f"restored checkpoint: {len(differ)} leaves differ, placements kept: {same_placements}")
    if not all(math.isfinite(x) for x in losses):
        why.append("losses not finite")
    if "error" in moe:
        why.append(f"shard_map MoE: {moe['error']}")
    elif (moe["y_err"] > MOE_SM_TOL or moe["aux_err"] > MOE_SM_TOL or not moe["grads_finite"]
          or max(moe["grad_rel_to_max"].values()) > MOE_SM_TOL
          or moe["exchanges"] != {"forward": 2, "backward": 2}):
        why.append("shard_map MoE off the dense MoE, or not 2 + 2 exchanges")
    if why:
        fail("train_mesh", "; ".join(why), **summary)
    emit("train_mesh", ok=True, **summary)
    return launches


DRYRUN = dict(arch="qwen3-1.7b", reduced=False, layers=0, seq=2048, batch=4, device_type="cuda")
DRYRUN_PEAK_TOL = 0.05  # predicted peak (argument + temp bytes) against max_memory_allocated
DRYRUN_CELLS = (("mamba2-370m", "decode_32k", False), ("qwen2-vl-2b", "decode_32k", True),
                ("qwen3-1.7b", "decode_32k", False))  # the reference test's two cells, and Qwen3-1.7B


LAYOUT_WORKERS = 6  # dry-run processes at a time (host only: the machine's cores)


def layout_archs() -> tuple:
    """The archs of the reference's one-cycle fixture (a JSON file)."""
    with open(os.path.join(HERE, "tests", "data", "ref_dryrun_train_4k.json")) as f:
        return tuple(json.load(f)["one_cycle"])


def layout_cells(archs=None, device_type: str = "cuda") -> list:
    """(c) of the ``dryrun`` phase: each arch's (default
    :func:`layout_archs`) ``train_4k × 16x16`` step cut to one layer cycle
    at full width, through ``python -m repro_torch.launch.dryrun --cycles 1``
    (:data:`LAYOUT_WORKERS` processes at a time), held by
    ``launch.dryrun.layout_bars`` to the reference's compiled dry run
    (``tests/data/ref_dryrun_train_4k.json``, a JSON file: nothing of JAX is
    imported) and to the port's numbers before and after its layout
    followed the reference's (``tests/data/port_dryrun_{before,after}.json``);
    the archs of ``launch.dryrun.DEPTH_ARCHS`` also at two cycles, held by
    ``depth_bars``. Prints one line a cell and returns the cells' summaries
    (``ok``: every bar met)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as D

    archs = layout_archs() if archs is None else archs
    data = os.path.join(HERE, "tests", "data")
    with open(os.path.join(data, "ref_dryrun_train_4k.json")) as f:
        ref = json.load(f)["one_cycle"]
    with open(os.path.join(data, "port_dryrun_before.json")) as f:
        before = json.load(f)["train_4k"]
    with open(os.path.join(data, "port_dryrun_after.json")) as f:
        after = json.load(f)["train_4k"]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    tmp = tempfile.mkdtemp(prefix="layout_cells_")

    def run(task):
        arch, cycles = task
        t = time.perf_counter()
        out_dir = os.path.join(tmp, f"{arch}_{cycles}")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", "train_4k",
               "--cycles", str(cycles), "--out", out_dir, "--device", device_type]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=HERE, env=env)
        recs = [json.load(open(os.path.join(out_dir, f))) for f in os.listdir(out_dir)] \
            if os.path.isdir(out_dir) else []
        rec = recs[0] if recs else {"ok": False, "error": proc.stderr[-2000:]}
        rec.update(rc=proc.returncode, seconds=time.perf_counter() - t)
        return task, rec

    # the two-cycle cells, the longest, first
    tasks = [(a, 2) for a in archs if a in D.DEPTH_ARCHS] + [(a, 1) for a in archs]
    try:
        with ThreadPoolExecutor(LAYOUT_WORKERS) as pool:
            recs = dict(pool.map(run, tasks))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cells = []
    for arch in archs:
        one, two = recs[(arch, 1)], recs.get((arch, 2))
        cell = {"arch": arch, "rc": one["rc"], "seconds": one["seconds"], "ok": False}
        bad = [r for r in (one, two) if r is not None and not r["ok"]]
        if bad:
            cell["error"] = bad[0].get("error")
            cell["traceback"] = bad[0].get("traceback", "")[-4000:]
        else:
            bars = D.layout_bars(one, ref[arch], before[arch], after[arch], D.cut(get_config(arch), 1),
                                 SHAPES["train_4k"], {"data": 16, "model": 16})
            if two is not None:
                bars.update(D.depth_bars(one, two, get_config(arch)))
                cell["seconds_two_cycles"] = two["seconds"]
            cell.update(bars=bars, trace_s=one["trace_s"], ok=all(b["ok"] for b in bars.values()),
                        collectives_by_op=dict(list(one["collectives_by_op"].items())[:3]))
        print(json.dumps({"layout_cell": cell}), flush=True)
        cells.append(cell)
    return cells


def dryrun_cell(spec: dict):
    """The cross-check's cell: (cfg, shape, DistConfig). Qwen3-1.7B at the
    train phase's shape with the flash kernel, remat full, one microbatch;
    ``spec`` may cut it (``reduced``, ``layers``) to rehearse on the CPU."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.sharding.rules import DistConfig

    cfg = (reduced_config if spec["reduced"] else get_config)(spec["arch"])
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    shape = ShapeConfig("train", spec["seq"], spec["batch"], "train")
    return cfg, shape, DistConfig(rules={}, attn_impl="kernel", remat="full", microbatches=1)


def dryrun_child(spec: dict) -> int:
    """``chip_smoke.py --dryrun-child SPEC``: the cross-check's dry run, the
    cell of ``spec`` on a (1, 1) mesh of ``spec["device_type"]`` under the
    fake process group at world 1, on meta tensors; prints its record as
    the last line."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh

    cfg, shape, dist = dryrun_cell(spec)
    with D.fake_world(1):
        mesh = make_host_mesh(1, spec["device_type"])
        fn, args, mesh, kind, dist = D.build_cell(cfg, shape, False, dist, mesh=mesh)
        rec = D.run_step(fn, args, kind, mesh, dist.rules)
    print(json.dumps(rec), flush=True)
    return 0


def dryrun_phase(card: str, device="cuda", cells=DRYRUN_CELLS, layout=None, **overrides) -> dict:
    """Phase ``dryrun``: (a) the dry run of the cross-check cell
    (:func:`dryrun_cell`) against the same step run for real: on a (1, 1)
    NCCL mesh (gloo on the CPU), state and batch placed by
    ``launch.dryrun.build_cell`` (``runtime.elastic.place``), with the
    ``RunFlags`` the dry run builds from the cell's ``DistConfig`` (the
    flash kernel, the plain RMSNorm), under ``roofline.hlo.StepCounter``;
    the dry run in a child process under the fake group at world 1 on meta
    tensors. Collectives by category (count and bytes), flash calls against
    the card's launches, argument bytes, and the predicted peak (argument +
    temp bytes) against ``max_memory_allocated`` from a reset (less what
    the process held beside the arguments), within
    :data:`DRYRUN_PEAK_TOL`. (b) ``python -m repro_torch.launch.dryrun``
    in a subprocess for each of ``cells``: each must be ``ok``. (c) the
    one-cycle ``train_4k`` cells of ``layout`` (None: every arch of the
    fixture) against the reference's compiled dry run, the large stacks at
    two cycles too (:func:`layout_cells`): every bar met. ``device``
    and ``overrides`` of :data:`DRYRUN` exist to rehearse the phase on the
    CPU. Returns the flash launches of the real step."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import init_process_group, make_host_mesh

    t_phase = time.perf_counter()
    spec = dict(DRYRUN, **overrides)
    kind = torch.device(device).type
    on_card = kind == "cuda"
    cfg, shape, dist_cfg = dryrun_cell(spec)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))

    # ---- (a) the real step ---------------------------------------------------
    init_process_group(kind)
    try:
        mesh = make_host_mesh(1, kind)
        fn, args, mesh, step_kind, dist_cfg = D.build_cell(cfg, shape, False, dist_cfg, mesh=mesh,
                                                           device=device)
        real_args = D.local_bytes(args)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            beside_args = torch.cuda.memory_allocated() - real_args  # whatever else this process holds
            torch.cuda.reset_peak_memory_stats()
        FK.reset_launches()
        t = time.perf_counter()
        real = D.run_step(fn, args, step_kind, mesh, dist_cfg.rules)
        if on_card:
            torch.cuda.synchronize()
            measured_peak = torch.cuda.max_memory_allocated() - beside_args
        real_s = time.perf_counter() - t
        launches = FK.flash_attention_cuda.launches
        del fn, args
    finally:
        dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()

    # ---- (a) the dry run, in a child process --------------------------------------
    spec_child = dict(spec, device_type=kind)
    t = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--dryrun-child",
                            json.dumps(spec_child)], capture_output=True, text=True, timeout=900,
                           cwd=HERE, env=env)
    child_s = time.perf_counter() - t
    if child.returncode != 0:
        fail("dryrun", "the dry-run child failed", rc=child.returncode, stderr=child.stderr[-3000:])
    dry = json.loads(child.stdout.strip().splitlines()[-1])
    predicted_peak = dry["memory"]["argument_bytes"] + dry["memory"]["temp_bytes"]
    cross = dict(
        model=cfg.name, layers=cfg.n_layers, batch=shape.global_batch, seq=shape.seq_len, mesh=[1, 1],
        dist=dict(attn_impl="kernel", remat="full", microbatches=1, norm_impl="reference"),
        collective_counts={"card": real["collective_counts"], "dry_run": dry["collective_counts"]},
        collectives={"card": real["collectives"], "dry_run": dry["collectives"]},
        flash={"card_launches": launches, "card_counted": real["kernels"]["flash"],
               "dry_run": dry["kernels"]["flash"], "want": 2 * cfg.n_layers},
        argument_bytes={"card": real_args, "dry_run": dry["memory"]["argument_bytes"]},
        peak_bytes={"card_max_memory_allocated": measured_peak if on_card else None,
                    "dry_run_predicted": predicted_peak,
                    "card_counted": real_args + real["memory"]["temp_bytes"],
                    "rel_err": (predicted_peak - measured_peak) / measured_peak if on_card else None,
                    "tol": DRYRUN_PEAK_TOL},
        card_step_s=real_s, dry_run_trace_s=dry["trace_s"], child_s=child_s,
        cost={"card": real["cost"], "dry_run": dry["cost"]})

    # ---- (b) production cells ------------------------------------------------------
    prod, tmp = [], tempfile.mkdtemp(prefix="dryrun_cells_")
    try:
        for arch, shape_name, multi_pod in cells:
            t = time.perf_counter()
            out_dir = os.path.join(tmp, f"{arch}_{shape_name}_{int(multi_pod)}")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape_name,
                   "--out", out_dir, "--device", kind] + (["--multi-pod"] if multi_pod else [])
            run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=HERE, env=env)
            recs = [json.load(open(os.path.join(out_dir, f))) for f in sorted(os.listdir(out_dir))] \
                if os.path.isdir(out_dir) else []
            rec = recs[0] if recs else {"arch": arch, "shape": shape_name, "ok": False,
                                        "error": run.stderr[-2000:]}
            rec.update(rc=run.returncode, seconds=time.perf_counter() - t)
            print(json.dumps({"dryrun_cell": {k: v for k, v in rec.items() if k != "traceback"}}), flush=True)
            prod.append(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- (c) the layout against the reference's compiled step ------------------
    lay = layout_cells(layout)  # a "cuda"-typed mesh of meta tensors: no card needed

    summary = dict(crosscheck=cross, cells=[{k: r.get(k) for k in ("arch", "shape", "mesh", "ok", "rc",
                                                                   "seconds", "trace_s", "error")}
                                            for r in prod],
                   layout=[{k: c.get(k) for k in ("arch", "ok", "seconds", "error")} for c in lay],
                   card=card, seconds=time.perf_counter() - t_phase)
    why = []
    if real["collective_counts"] != dry["collective_counts"] or real["collectives"] != dry["collectives"]:
        why.append("collectives differ between the card's step and the dry run")
    if dry["kernels"]["flash"] != 2 * cfg.n_layers or (on_card and launches != dry["kernels"]["flash"]):
        why.append(f"flash: {dry['kernels']['flash']} dry-run calls, {launches} launches")
    if real_args != dry["memory"]["argument_bytes"]:
        why.append("argument bytes differ")
    if on_card and abs(predicted_peak - measured_peak) > DRYRUN_PEAK_TOL * measured_peak:
        why.append(f"predicted peak {predicted_peak} against {measured_peak} measured")
    bad = [f"{r['arch']} × {r['shape']}: {r.get('error', '')[:300]}" for r in prod if not r["ok"] or r["rc"]]
    if bad:
        why.append("cells not ok: " + "; ".join(bad))
    off = [f"{c['arch']}: " + (c.get("error") or ", ".join(k for k, b in c["bars"].items() if not b["ok"]))[:300]
           for c in lay if not c["ok"]]
    if off:
        why.append("layout off the reference's: " + "; ".join(off))
    if why:
        fail("dryrun", "; ".join(why), **summary)
    emit("dryrun", ok=True, **summary)
    return {"flash": launches}


PHASE_OUTPUT_CASES = [("ar_complex", n, b) for n in (1, 2, 3) for b in TIMING_BATCHES] + [
    (t, n, b) for t in (1, 31, 33, 100) for n in (1, 2, 8) for b in (4, 4096)] + [
    (t, n, 4) for t in (257, 1024) for n in (1, 2, 8)]


def phase_sim_outputs(db, bud) -> dict:
    """The phase-sim kernel's packed output rows on fixed inputs
    (ar_complex at the timing shapes, synthetic graphs of 1-1024 tasks), as
    int32 bits: what two versions of the kernel are compared on bit for bit.
    Uses only entry points every version of the port has."""
    import torch

    from repro_torch.core import ar_complex
    from repro_torch.core.backend import _bucket
    from repro_torch.core.phase_sim_torch import rows_to
    from repro_torch.kernels.phase_sim import kernel as K
    from repro_torch.kernels.phase_sim import ops

    outs = {}
    for name, n_noc, b in PHASE_OUTPUT_CASES:
        if name == "ar_complex":
            g = ar_complex()
            enc, rows = population(g, bud, n_noc, b, seed=7 + b, db=db, slots=_bucket(len(g.tasks)))
        else:
            g, gb = sized_scenario(name, seed=name, db=db)
            enc, rows = population(g, gb, n_noc, b, seed=10 * n_noc + b, db=db)
        dev = rows_to(rows, "cuda")
        lay = K.out_layout(len(enc.names), rows["pe_peak"].shape[1], rows["mem_bw"].shape[1],
                           n_noc, len(enc.wl_names))
        out = torch.empty((b, lay["width"]), dtype=torch.float32, device="cuda")
        K.phase_sim_cuda(enc.on("cuda"), dev, ops.pack_nocs(dev), out)
        outs[f"{name}/{n_noc}/{b}"] = out.view(torch.int32).cpu()
    return outs


def kernel_times(card: str, outputs_path=None) -> dict:
    """The phase-sim, flash, SSD and RMSNorm kernels' device times at the
    timing phases' shapes, through the entry points every version of the
    port has (``phase_sim_cuda``; ``flash_attention_cuda`` on contiguous
    (B, H, S, Dh) inputs and ``ops.flash_attention`` on (B, S, H, Dh);
    ``ssd_cuda`` on contiguous inputs and ``ops.ssd`` on the model's slices
    of one projection; ``rmsnorm_cuda`` and the host cost of
    ``ops.rmsnorm``); for timing two trees on one card. With
    ``outputs_path``: saves the phase-sim outputs of :func:`phase_sim_outputs`
    there, or, where the file exists, counts the outputs that differ from
    it bit for bit."""
    import torch

    import repro_torch
    from repro_torch.core import HardwareDatabase, ar_complex, calibrated_budget
    from repro_torch.core.backend import _bucket
    from repro_torch.core.phase_sim_torch import rows_to
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.phase_sim import kernel as K
    from repro_torch.kernels.phase_sim import ops as phase_ops
    from repro_torch.kernels.rmsnorm import kernel as NK
    from repro_torch.kernels.rmsnorm.ops import rmsnorm as rms_ops
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ops import ssd as ssd_ops

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:  # one nvcc per source, all started together
        for f in [pool.submit(m.build) for m in (K, FK, SK, NK)]:
            f.result()
    out = {"src": os.path.relpath(os.path.dirname(os.path.dirname(repro_torch.__file__)), HERE),
           "card": card, "phase_sim": {}, "flash": {}, "ssd": {}, "rmsnorm": {}}
    db = HardwareDatabase()
    bud = calibrated_budget(db)
    g = ar_complex()
    for b in TIMING_BATCHES:
        enc, rows = population(g, bud, 1, b, seed=7 + b, db=db, slots=_bucket(len(g.tasks)))
        dev = rows_to(rows, "cuda")
        w, nocs = enc.on("cuda"), phase_ops.pack_nocs(dev)
        lay = K.out_layout(len(enc.names), rows["pe_peak"].shape[1], rows["mem_bw"].shape[1], 1,
                           len(enc.wl_names))
        res = torch.empty((b, lay["width"]), dtype=torch.float32, device="cuda")
        out["phase_sim"][b] = dict(ms=cuda_time_ms(lambda: K.phase_sim_cuda(w, dev, nocs, res),
                                                   200 if b <= 256 else 50))
    if outputs_path:
        got = phase_sim_outputs(db, bud)
        if os.path.exists(outputs_path):
            want = torch.load(outputs_path)
            out["phase_sim_bitwise"] = dict(
                against=outputs_path, cases=len(got),
                outputs=sum(v.numel() for v in got.values()),
                differing=sum(int((got[k] != want[k]).sum()) for k in got))
        else:
            os.makedirs(os.path.dirname(os.path.abspath(outputs_path)), exist_ok=True)
            torch.save(got, outputs_path)
            out["phase_sim_bitwise"] = dict(saved=outputs_path, cases=len(got))
    for s in (PREFILL["s"], 2048):
        b, h, kh, dh = PREFILL["b"], PREFILL["h"], PREFILL["kh"], PREFILL["dh"]
        q, k, v = flash_inputs(b, h, kh, s, dh, torch.bfloat16, seed=s)
        qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        out["flash"][s] = dict(
            ms=cuda_time_ms(lambda: FK.flash_attention_cuda(q, k, v, causal=True), 50),
            ops_ms=cuda_time_ms(lambda: flash_attention(qm, km, vm, causal=True), 50))
    for s in (SSD_TIMED[1], 2048):
        b, _, h, p, n, q = SSD_TIMED
        args = ssd_model_inputs(b, s, h, p, n, seed=s)
        dense = [t.contiguous() for t in args]
        out["ssd"][s] = dict(ms=cuda_time_ms(lambda: SK.ssd_cuda(*dense, q), 50),
                             ops_ms=cuda_time_ms(lambda: ssd_ops(*args, chunk=q), 50))
    for rows, d in RMS_TIMED:
        g = torch.Generator(device="cuda").manual_seed(rows + d)
        x = torch.randn(rows, d, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(d, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        out["rmsnorm"][f"{rows}x{d}"] = dict(ms=cuda_time_ms(lambda: NK.rmsnorm_cuda(x, w), 200),
                                             host_us=host_us(lambda: rms_ops(x, w)))
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-times", action="store_true",
                    help="only time the four kernels and print one JSON line")
    ap.add_argument("--src", default=None,
                    help="with --kernel-times or --train-mesh-wall: the root of another checkout whose src/ to run")
    ap.add_argument("--outputs", default=None,
                    help="with --kernel-times: save the phase-sim outputs to this file, or, where "
                         "it exists, count the outputs that differ from it bit for bit")
    ap.add_argument("--train-mesh-wall", action="store_true",
                    help="only run the train_mesh phase (with --src: another checkout's src/) and print "
                         "its step wall as one JSON line")
    ap.add_argument("--dryrun-child", default=None, metavar="SPEC",
                    help="internal: the dryrun phase's dry run of the cell SPEC (JSON)")
    args = ap.parse_args()
    if args.dryrun_child:
        return dryrun_child(json.loads(args.dryrun_child))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS's deterministic workspace, set before its first handle: the
    # train phase's recovered run is held to the uninterrupted one bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if args.train_mesh_wall:
        if args.src:
            sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
        import repro_torch

        card = smi_line()
        launches = train_mesh_phase(card)
        print(json.dumps({"train_mesh_wall": {"src": os.path.dirname(os.path.dirname(repro_torch.__file__)),
                                              "launches": launches, "card": card}}), flush=True)
        return 0
    if args.kernel_times:
        if args.src:
            sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
        print(json.dumps({"kernel_times": kernel_times(smi_line(), args.outputs)}), flush=True)
        return 0
    from repro_torch.core import (
        Explorer, ExplorerConfig, HardwareDatabase, ar_complex, audio,
        calibrated_budget, distance, edge_detection, simulate, synthetic_family,
    )
    from repro_torch.core.backend import _bucket  # the backend's slot bucket
    from repro_torch.core.phase_sim_torch import rows_to
    from repro_torch.kernels.phase_sim import kernel as K
    from repro_torch.kernels.phase_sim import ops
    from repro_torch.kernels.phase_sim.ref import phase_sim_ref

    # parity paths run in full f32: no TF32 anywhere (the kernel and the
    # plain version use no matrix product, but the setting is stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi_line()
    emit("env", ok=True, card=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0], tf32=False)

    # ---- build (the flash kernel compiles meanwhile, in its own nvcc) ------
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm import kernel as NK
    from repro_torch.kernels.ssd import kernel as SK

    pool = ThreadPoolExecutor(3)  # one nvcc per source, all started together
    flash_build = pool.submit(timed, FK.build)
    ssd_build = pool.submit(timed, SK.build)
    rms_build = pool.submit(timed, NK.build)
    pool.shutdown(wait=False)
    t0 = time.perf_counter()
    lib = K.build()
    ptxas = [ln.strip() for ln in K.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit("build", ok=True, seconds=time.perf_counter() - t0, library=os.path.relpath(lib, HERE),
         flags=" ".join(K.NVCC_FLAGS), ptxas=ptxas)

    # ---- parity ------------------------------------------------------------
    db = HardwareDatabase()
    bud = calibrated_budget(db)
    syn = synthetic_family(3, 1, db, min_tasks=48, max_tasks=100)[0]
    graphs = (("audio", audio(), bud), ("ar_complex", ar_complex(), bud),
              (syn.name, syn.tdg, syn.budget))
    t0 = time.perf_counter()

    def populations():
        for gname, g, gb in graphs:
            for n_noc in (1, 2, 3):
                for b in PARITY_BATCHES:
                    # half the shapes padded as the backend pads them (the slot
                    # bucket may exceed the thread count), half unpadded
                    slots = _bucket(len(g.tasks)) if b in (4, 4096) else 0
                    yield gname, n_noc, b, population(g, gb, n_noc, b, seed=1000 * n_noc + b, db=db,
                                                      slots=slots)
        for t, n_noc, b in TASK_CASES:
            g, gb = sized_scenario(t, seed=t, db=db)
            yield g.name, n_noc, b, population(g, gb, n_noc, b, seed=10 * n_noc + b, db=db)
        for t in RANDOM_DAG_TASKS:
            for seed in RANDOM_DAG_SEEDS:
                g, enc, rows = random_dag_rows(t, seed, db)
                yield g.name, 1, RANDOM_DAG_DESIGNS, (enc, rows)

    worst_rel, worst_abs, cases, failures = 0.0, 0.0, [], []
    dag_cols = dict.fromkeys(CHECK_KEYS, 0.0)  # random DAGs: worst relative error per column
    for gname, n_noc, b, (enc, rows) in populations():
        dev = rows_to(rows, "cuda")
        got = ops.phase_sim(enc, dev)
        torch.cuda.synchronize()
        want = phase_sim_ref(enc, dev)
        torch.cuda.synchronize()
        rel, ab, key, bad = compare(want, got)
        if gname.startswith("rand"):
            for col, err in column_errors(want, got).items():
                dag_cols[col] = max(dag_cols[col], err)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, ab)
        case = {"graph": gname, "tasks": len(enc.names), "nocs": n_noc, "batch": b,
                "slots": rows["pe_peak"].shape[1], "max_rel_err": rel,
                "max_abs_err": ab, "worst": key}
        cases.append(case)
        if rel > REL_TOL or bad:
            failures.append({**case, "exact": bad})
    if failures:
        fail("parity", "kernel disagrees with the plain version", failures=failures[:12],
             n_failed=len(failures), n_cases=len(cases))
    emit("parity", ok=True, cases=len(cases), max_rel_err=worst_rel, max_abs_err=worst_abs,
         tol=REL_TOL, exact=list(EXACT_KEYS), tasks=sorted({c["tasks"] for c in cases}),
         random_dag_max_rel_err=dag_cols, seconds=time.perf_counter() - t0)

    # ---- timing (at the main path's padded shapes) ---------------------------
    g = ar_complex()
    timings = {}
    for n_noc in (1, 2):
        for b in TIMING_BATCHES:
            enc, rows = population(g, bud, n_noc, b, seed=7 + b, db=db,
                                   slots=_bucket(len(g.tasks)))
            dev = rows_to(rows, "cuda")
            w = enc.on("cuda")
            nocs = ops.pack_nocs(dev)
            lay = K.out_layout(len(enc.names), rows["pe_peak"].shape[1],
                               rows["mem_bw"].shape[1], n_noc, len(enc.wl_names))
            out = torch.empty((b, lay["width"]), dtype=torch.float32, device="cuda")
            launches0 = K.phase_sim_cuda.launches
            reps = 200 if b <= 256 else 50
            ms = cuda_time_ms(lambda: K.phase_sim_cuda(w, dev, nocs, out), reps)
            launches = K.phase_sim_cuda.launches - launches0
            plain_ms = wall_ms(lambda: phase_sim_ref(enc, dev), 5 if b < 4096 else 3)
            n_phases = ops.unpack(out, enc, rows["pe_peak"].shape[1],
                                  rows["mem_bw"].shape[1], n_noc)["n_phases"]
            bound_ms, bound_by, nbytes, nops = bound(dev, enc, n_phases)
            timings[(n_noc, b)] = (ms, plain_ms, bound_ms, bound_by)
            emit("timing", ok=True, graph="ar_complex", nocs=n_noc, batch=b,
                 slots=rows["pe_peak"].shape[1], ms=ms,
                 plain_ms=plain_ms, library_ms=None, launches=launches,
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=nops,
                 card=card)

    # ---- main path ---------------------------------------------------------
    g = ar_complex()
    K.phase_sim_cuda.launches = 0
    t0 = time.perf_counter()
    ex = Explorer(g, db, bud, ExplorerConfig(
        awareness="farsi", max_iterations=MAIN_ITERATIONS, seed=1))
    res = ex.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = K.phase_sim_cuda.launches
    st = ex.backend.stats()
    fit = distance(simulate(res.best_design, g, db), bud).fitness(0.05)
    last = res.history[-1]["fitness"]
    rel = abs(fit - last) / max(abs(fit), 1e-12)
    summary = dict(
        backend=res.backend_name, device=str(ex.backend.device), iterations=res.iterations,
        converged=res.converged, n_sims=res.n_sims, wall_s=wall,
        sims_per_s=res.n_sims / wall, encode_s=st.encode_s, dispatch_s=st.dispatch_s,
        decode_s=st.decode_s, backend_wall_s=st.wall_s, n_dispatches=st.n_dispatches,
        n_fallback=st.n_fallback, n_compiles=st.n_compiles, launches=main_launches,
        repriced_fitness=fit, history_fitness=last, fitness_rel_err=rel, card=card,
    )
    if ex.backend.device.type != "cuda":
        fail("main_path", "the explorer did not price on the card", **summary)
    if main_launches < res.iterations:
        fail("main_path", "fewer kernel launches than iterations", **summary)
    if st.n_fallback != 0:
        fail("main_path", "candidates fell back to the scalar simulator", **summary)
    if rel > REL_TOL:
        fail("main_path", "best design re-priced off the search's fitness", **summary)
    emit("main_path", ok=True, **summary)

    # ---- golden sequences ----------------------------------------------------
    with open(os.path.join(HERE, "tests", "golden_policy_seqs.json")) as f:
        gold = json.load(f)
    graphs = {"audio": audio, "ar_complex": ar_complex, "ed": edge_detection}
    replayed = []
    for key in GOLDEN_CELLS:
        ref = gold[key]
        gname, aware, s, it = key.split(".")
        r = Explorer(graphs[gname](), db, bud, ExplorerConfig(
            awareness=aware, max_iterations=int(it[2:]), seed=int(s[1:]))).run()
        seq = [[h["iteration"], h["move"], int(h["accepted"])] for h in r.history]
        if seq != ref["seq"] or r.n_sims != ref["n_sims"]:
            first = next((i for i, (a, b) in enumerate(zip(seq, ref["seq"])) if a != b),
                         min(len(seq), len(ref["seq"])))
            fail("golden", f"{key} diverged from the recorded sequence", first_diff=first,
                 n_sims=r.n_sims, want_n_sims=ref["n_sims"])
        replayed.append({"cell": key, "iterations": len(seq), "n_sims": r.n_sims})
    emit("golden", ok=True, cells=replayed)

    chain_launches = chain_phases(card, db, bud, summary["sims_per_s"])
    analysis_launches = analysis_phase(card)
    serve_launches = serve_phases(card, db, bud, summary["sims_per_s"])

    flash = flash_phases(card, flash_build)
    ssd_entry, rms_entry = mamba_phases(card, ssd_build, rms_build)
    moe = serve_moe_phase(card)
    jamba, qwen_moe = moe["jamba-v0.1-52b"], moe["qwen3-moe-235b-a22b"]
    flash.update(flash_grad_phase(card))
    train_launches = train_phase(card)
    moe_train_launches = train_moe_phase(card)
    mesh_launches = train_mesh_phase(card, beside=train_launches)
    dryrun_launches = dryrun_phase(card)
    flash["launches_by_path"] = {"serve": flash["launches"], "serve_moe": jamba["flash"],
                                 "serve_moe_qwen3": qwen_moe["flash"],
                                 "train_step": train_launches["flash"],
                                 "train_moe_step": moe_train_launches["flash"],
                                 "train_mesh_step": mesh_launches["flash"],
                                 "dryrun_crosscheck_step": dryrun_launches["flash"]}
    ssd_entry["launches_by_path"] = {"serve_mamba": ssd_entry["launches"], "serve_moe": jamba["ssd"]}
    rms_entry["launches_by_path"] = {"serve_mamba": rms_entry["launches"],
                                     "serve_moe": jamba["rmsnorm"],
                                     "serve_moe_qwen3": qwen_moe["rmsnorm"],
                                     "train_step": train_launches["rmsnorm"],
                                     "train_moe_step": moe_train_launches["rmsnorm"],
                                     "train_mesh_step": mesh_launches["rmsnorm"]}

    # ---- kernels -------------------------------------------------------------
    ms, plain_ms, bound_ms, bound_by = timings[(1, 4)]  # the main path's shape
    print(json.dumps({"kernels": [{
        "name": "phase_sim",
        "route": "cuda",
        "source": "src/repro_torch/kernels/phase_sim/csrc/phase_sim.cu",
        "replaces": "src/repro/kernels/phase_sim/kernel.py:54",
        "launches": main_launches,
        # each path's own count, zeroed just before its run: the last timed
        # chain block at each R (one launch per iteration), then run_chains
        "launches_by_path": {"main_path": main_launches, "chain_block": chain_launches["chain"],
                             "chain_explore": chain_launches["chain_explore"],
                             "analysis": analysis_launches, **serve_launches},
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, flash, ssd_entry, rms_entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
