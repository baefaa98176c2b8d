#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Drives the port's three paths and checks them: FARSI's price-and-search
loop, ``Explorer.run()`` on the AR workload complex, through the CUDA
phase-sim kernel; serving Qwen3-1.7B at full width and depth (``generate``:
prefill and greedy decode) through the CUDA flash-attention kernel; and
serving Mamba2-370m at full width and depth through the CUDA SSD and RMSNorm
kernels. Phases, each printing one JSON line:

  1. env       card name and power limit, torch / CUDA versions
  2. build     nvcc build of the kernel (registers, shared memory, spills)
  3. parity    kernel vs its plain PyTorch version on the card, every output
               column, ≤ 1e-5 relative, codes, phase counts and argmaxes
               exact (audio, ar_complex and a > 32-task synthetic graph at
               1–3 NoCs; synthetic graphs of 1, 28, 31, 32, 33, 64, 257 and
               1024 tasks at 1, 2 and 8 NoCs; B ∈ {1, 4, 256, 4096}, fewer
               at 257 and 1024 tasks)
  4. timing    kernel and plain-version times (CUDA events) beside the bound
  5. main_path Explorer.run() on ar_complex, farsi, seed 1, 500 iterations;
               the kernel's launch count is zeroed just before and read just
               after, and the best design is re-priced by the scalar simulator
  6. golden    two recorded accepted-move sequences replayed on the card
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
                   128, and S=2048 (contiguous, through ssd_cuda); and
                   ops.ssd on x, B and C sliced from one projection at chunk,
                   P and N in {64, 128}, S from one chunk to 2048, bf16 and
                   f32; each case reports the route it took and fails on
                   another than kernel.route names; y <= 5e-2 (bf16) / 1e-3
                   (f32), h <= 1e-3, the reference's own bars
 13. rmsnorm_parity  RMSNorm kernel vs its plain version: test_kernels.py's
                   shapes, (2048, 1024), (2048, 2048), (4, 1024), (4, 2048),
                   a ragged (1000, 1024), an odd (33, 1001), qk-norm's
                   (32768, 128), (16, 8192), (4, 12288), and x one element
                   past 16-byte alignment; f32, bf16, bf16 with an f32
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
 17. kernels   one line per ported kernel (launches, error, times, bound;
               flash and SSD also their launches per route)

then the card's ``nvidia-smi`` name/power-limit line and, last, the result
object.

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
]
# (B, S, H, P, N, chunk, dtype) through ops.ssd on x, B and C sliced from one
# projection, as the model passes them: bf16 takes the tensor-core route at
# every chunk, P and N in {64, 128} and S from one chunk to 2048, reading the
# slices in place; f32 the CUDA-core route
SSD_ROUTE_CASES = [(2 if s < 2048 else 1, s, 4 if s < 2048 else 2, p, n, q, dt)
                   for dt in ("bfloat16", "float32") for q in (64, 128) for p in (64, 128)
                   for n in (64, 128) for s in sorted({q, 512, 2048})
                   if dt == "bfloat16" or (q, p, n) != (128, 128, 128)]  # 276 KB: beyond the CUDA cores' kernel
SSD_TILE_TOL = 1e-4  # one wgmma tile vs torch.matmul, over the tile's largest |value|
SSD_TIMED = (4, 512, 32, 64, 128, 64)  # serve_mamba's prefill shape, bf16, chunk 64
RMS_TOL = {"bfloat16": 2e-2, "float32": 1e-5}  # the reference's bars (tests/test_kernels.py)
# tests/test_kernels.py's shapes, serve_mamba's prefill and decode rows, a ragged count
# an odd width, Qwen3's qk-norm rows (d = 128 over B*S*H rows), wide rows
# (d = 8192, Mistral's 12288: a block per row)
RMS_SHAPES = [(64, 128), (2, 32, 64), (256, 512), (2048, 1024), (2048, 2048), (4, 1024),
              (4, 2048), (1000, 1024), (33, 1001), (32768, 128), (16, 8192), (4, 12288)]
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
    emit("ssd_parity", ok=True, cases=cases, worst=ssd_worst, tile_err=tile_err,
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
                    help="with --kernel-times: the root of another checkout whose src/ to time")
    ap.add_argument("--outputs", default=None,
                    help="with --kernel-times: save the phase-sim outputs to this file, or, where "
                         "it exists, count the outputs that differ from it bit for bit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    worst_rel, worst_abs, cases, failures = 0.0, 0.0, [], []
    for gname, n_noc, b, (enc, rows) in populations():
        dev = rows_to(rows, "cuda")
        got = ops.phase_sim(enc, dev)
        torch.cuda.synchronize()
        want = phase_sim_ref(enc, dev)
        torch.cuda.synchronize()
        rel, ab, key, bad = compare(want, got)
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
         seconds=time.perf_counter() - t0)

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

    flash = flash_phases(card, flash_build)
    ssd_entry, rms_entry = mamba_phases(card, ssd_build, rms_build)

    # ---- kernels -------------------------------------------------------------
    ms, plain_ms, bound_ms, bound_by = timings[(1, 4)]  # the main path's shape
    print(json.dumps({"kernels": [{
        "name": "phase_sim",
        "route": "cuda",
        "source": "src/repro_torch/kernels/phase_sim/csrc/phase_sim.cu",
        "replaces": "src/repro/kernels/phase_sim/kernel.py:54",
        "launches": main_launches,
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
