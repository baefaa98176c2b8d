"""The CUDA phase-sim kernel on the card, against the port's own plain
PyTorch version and CPU path. Every test here needs a CUDA device: each
carries the ``gpu`` marker and skips where there is none.

This file imports only the port and ``chip_smoke.py``'s workload helpers
(no JAX, no JAX package), so it runs on a machine that has PyTorch with CUDA
and nothing else of the test suite:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import random
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import phase_sim_torch as PT  # noqa: E402
from repro_torch.core.moves import apply_fork  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import TASK_CASES, population, sized_scenario  # noqa: E402

REL_TOL = 1e-5  # kernel vs plain version, every output column
KEYS = (
    "latency_s", "finish_s", "bneck_code", "bneck_kind_s", "alp_time_s",
    "traffic_bytes", "n_phases", "wl_latency_s", "energy_j", "power_w",
    "area_mm2", "fitness", "all_done", "pe_bneck_s", "mem_bneck_s",
    "noc_bneck_s", "top_bneck_pe", "top_bneck_mem",
)
EXACT = ("bneck_code", "n_phases", "all_done", "top_bneck_pe", "top_bneck_mem")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # parity runs in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def designs(g, n_noc, count, seed):
    """Random single-NoC designs, or ``n_noc``-deep chains built by real NoC
    forks on a design with a few added blocks, remapped so routes span the
    chain."""
    if n_noc == 1:
        return P.random_single_noc_designs(g, count, seed=seed)
    rng = random.Random(seed)
    tasks = sorted(g.tasks)
    out = []
    for _ in range(count):
        d = P.Design.base(g)
        noc0 = d.noc_chain[0]
        for _ in range(rng.randint(2, 4)):
            if rng.random() < 0.5:
                t = rng.choice(tasks)
                d.task_pe[t] = d.add_block(
                    P.make_accelerator(t, rng.choice((100, 400))), attach_to=noc0).name
            else:
                d.add_block(P.make_mem(rng.choice(("dram", "sram")), rng.choice((100, 800)), 32),
                            attach_to=noc0)
        while len(d.noc_chain) < n_noc:
            assert apply_fork(d, g, rng.choice(d.noc_chain))
        pes, mems = d.pes(), d.mems()
        for t in tasks:
            d.task_pe[t] = rng.choice(pes)
            d.task_mem[t] = rng.choice(mems)
        out.append(d)
    return out


def rows_for(g, n_noc, count, seed, slots=0):
    db = P.HardwareDatabase()
    bud = P.calibrated_budget(db)  # workloads it does not name score neutral
    enc = PT.EncodedWorkload.of(g)
    rows = PT.encode_batch(designs(g, n_noc, count, seed), g, db, enc, n_pe=slots, n_mem=slots)
    for j in range(count):
        PT.fill_budget(rows, j, enc, bud.latency_s, bud.power_w, bud.area_mm2, 0.05)
    return enc, rows


def assert_close(got, want, ctx):
    for k in KEYS:
        a, b = want[k].cpu(), got[k].cpu()
        assert a.shape == b.shape and a.dtype == b.dtype, (ctx, k)
        if k in EXACT:
            assert torch.equal(a, b), (ctx, k)
            continue
        a64, b64 = a.double(), b.double()
        rel = ((a64 - b64).abs() / a64.abs().clamp(min=1e-12)).max().item() if a.numel() else 0.0
        assert rel <= REL_TOL, (ctx, k, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("graph", ["audio", "ar_complex", "synthetic"])
@pytest.mark.parametrize("n_noc", [1, 2, 3])
def test_kernel_matches_plain_version(cuda, graph, n_noc):
    from repro_torch.kernels.phase_sim import ops
    from repro_torch.kernels.phase_sim.kernel import phase_sim_cuda
    from repro_torch.kernels.phase_sim.ref import phase_sim_ref

    if graph == "synthetic":  # > 32 tasks: a multi-warp block, slots > threads
        g = P.synthetic_family(3, 1, min_tasks=48, max_tasks=100)[0].tdg
        slots = 128
    else:
        g, slots = getattr(P, graph)(), 0
    enc, rows = rows_for(g, n_noc, 64, seed=11 * n_noc, slots=slots)
    dev = PT.rows_to(rows, cuda)
    before = phase_sim_cuda.launches
    got = ops.phase_sim(enc, dev)
    torch.cuda.synchronize()
    assert phase_sim_cuda.launches == before + 1
    assert_close(got, phase_sim_ref(enc, dev), (graph, n_noc))
    # and the CPU path (padded plain version) prices the same rows alike
    assert_close(got, ops.phase_sim(enc, PT.rows_to(rows, "cpu")), (graph, n_noc, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("t,n_noc,b", TASK_CASES)
def test_kernel_matches_plain_version_at_task_counts(cuda, t, n_noc, b):
    """Synthetic AR-like graphs of t tasks (chip_smoke.sized_scenario) with
    n_noc-deep chain designs, chip_smoke's grid of task counts (around the
    one-warp path's edge at 32, up to the largest block): both instances of
    the kernel against the plain version, every column <= 1e-5, codes
    exact."""
    from repro_torch.kernels.phase_sim import ops
    from repro_torch.kernels.phase_sim.ref import phase_sim_ref

    db = P.HardwareDatabase()
    g, budget = sized_scenario(t, seed=t, db=db)
    enc, rows = population(g, budget, n_noc, b, seed=10 * n_noc + b, db=db)
    dev = PT.rows_to(rows, cuda)
    got = ops.phase_sim(enc, dev)
    torch.cuda.synchronize()
    assert_close(got, phase_sim_ref(enc, dev), (t, n_noc, b))


@pytest.mark.gpu
def test_kernel_refuses_tasks_beyond_one_block(cuda):
    from repro_torch.kernels.phase_sim.kernel import MAX_TASKS, phase_sim_cuda

    t = MAX_TASKS + 1
    w = PT.EncodedWorkload(
        work_ops=np.ones(t, np.float32), read_bytes=np.ones(t, np.float32),
        write_bytes=np.ones(t, np.float32), burst=np.ones(t, np.float32),
        llp=np.ones(t, np.float32), parent_mask=np.zeros((t, t), bool),
        wl_id=np.zeros(t, np.int32), names=[f"t{i}" for i in range(t)], wl_names=["w"],
    )
    rows = PT.rows_to(PT.alloc_rows(1, t, 4, 4, 1, 1), cuda)
    with pytest.raises(ValueError, match="tasks"):
        phase_sim_cuda(w.on(cuda), rows, torch.zeros(1, 4, device=cuda),
                       torch.empty(1, 1, device=cuda))


@pytest.mark.gpu
def test_backend_on_card_matches_cpu(cuda):
    g, db = P.ar_complex(), P.HardwareDatabase()
    bud = P.calibrated_budget(db)
    cands = [P.Candidate.of_design(d, bud) for d in designs(g, 2, 8, seed=4)]
    cpu = P.TorchBatchedBackend(g, db, device="cpu").evaluate_candidates(cands)
    be = P.TorchBatchedBackend(g, db)
    assert be.device.type == "cuda"
    got = be.evaluate_candidates(cands)
    for a, b in zip(cpu, got):
        assert abs(a.fitness - b.fitness) <= REL_TOL * max(abs(a.fitness), 1e-12)
        assert a.result().task_bottleneck == b.result().task_bottleneck
    assert be.stats().n_fallback == 0 and be.stats().n_batched == 8


@pytest.mark.gpu
def test_explorer_on_card_replays_cpu_search(cuda):
    from repro_torch.kernels.phase_sim.kernel import phase_sim_cuda

    def run(device):
        db = P.HardwareDatabase()
        ex = P.Explorer(P.audio(), db, P.calibrated_budget(db), P.ExplorerConfig(
            awareness="farsi", max_iterations=60, seed=7, device=device))
        return ex.run()

    before = phase_sim_cuda.launches
    on_card = run("cuda")
    assert phase_sim_cuda.launches - before >= on_card.iterations
    on_cpu = run("cpu")
    seq = lambda r: [[h["iteration"], h["move"], int(h["accepted"])] for h in r.history]
    assert seq(on_card) == seq(on_cpu) and on_card.n_sims == on_cpu.n_sims
