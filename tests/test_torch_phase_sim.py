"""The port's batched phase simulator (the plain PyTorch version of the CUDA
kernel) against the JAX package's ``simulate_batch``: the same rows, carried
across as numpy through ``from_reference``, give every output column within
1e-5 relative, integer outputs exactly. Also the kernel wrapper's CPU path
(task axis padded to whole warps, padded tasks born completed) against the
unpadded plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from _torch_helpers import (  # noqa: E402
    CHECK_KEYS, assert_outputs_close, reference_rows, workload_arrays,
)
from repro.core import phase_sim_jax as RJ  # noqa: E402
from repro_torch.core import phase_sim_torch as PT  # noqa: E402
from repro_torch.kernels.phase_sim import ops  # noqa: E402
from repro_torch.kernels.phase_sim.kernel import out_layout, padded_tasks  # noqa: E402
from repro_torch.kernels.phase_sim.ref import phase_sim_ref  # noqa: E402

GRAPHS = {"audio": R.audio, "ar_complex": R.ar_complex}


def port_inputs(renc, rows):
    return PT.from_reference(workload_arrays(renc), renc.names, renc.wl_names, rows, "cpu")


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("n_noc", [1, 2, 3])
@pytest.mark.parametrize("batch", [1, 8, pytest.param(64, marks=pytest.mark.slow)])
def test_plain_matches_jax_simulate_batch(name, n_noc, batch):
    import jax

    renc, rows = reference_rows(GRAPHS[name](), n_noc, batch, seed=10 * n_noc + batch)
    want = jax.jit(lambda r: RJ.simulate_batch(renc, r))(rows)
    enc, dev = port_inputs(renc, rows)
    got = phase_sim_ref(enc, dev)
    assert set(CHECK_KEYS) <= set(got)
    assert_outputs_close(got, {k: np.asarray(v) for k, v in want.items()}, (name, n_noc, batch))


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("n_noc", [1, 3])
def test_wrapper_cpu_path_pads_to_warps(name, n_noc):
    """``ops.phase_sim`` on CPU tensors pads T to a multiple of 32 and runs
    the plain version; padded tasks never run and vanish from every sum."""
    renc, rows = reference_rows(GRAPHS[name](), n_noc, 8, seed=5 + n_noc)
    enc, dev = port_inputs(renc, rows)
    t = len(enc.names)
    assert padded_tasks(t) % 32 == 0 and padded_tasks(t) > t
    want = phase_sim_ref(enc, dev)
    got = ops.phase_sim(enc, dev)
    assert_outputs_close(got, {k: v.numpy() for k, v in want.items()}, (name, n_noc))
    # the packed rows carry the layout the kernel writes
    packed = ops.phase_sim_rows(enc, dev)
    lay = out_layout(t, dev["pe_peak"].shape[1], dev["mem_bw"].shape[1], n_noc,
                     len(enc.wl_names))
    assert packed.shape == (8, lay["width"]) and packed.dtype == torch.float32


def test_wrapper_refuses_other_devices_and_mixed_rows():
    renc, rows = reference_rows(R.audio(), 1, 2, seed=1)
    enc, dev = port_inputs(renc, rows)
    with pytest.raises(ValueError):
        ops.phase_sim(enc, {**dev, "task_pe": dev["task_pe"].to("meta")})
    meta = {k: v.to("meta") for k, v in dev.items()}
    with pytest.raises(ValueError):
        ops.phase_sim(enc, meta)


def test_kernel_launcher_refuses_cpu_tensors():
    """The CUDA launcher checks devices before it touches the toolkit: a CPU
    tensor is refused, never priced by a hidden fallback."""
    from repro_torch.kernels.phase_sim.kernel import phase_sim_cuda

    renc, rows = reference_rows(R.audio(), 1, 2, seed=1)
    enc, dev = port_inputs(renc, rows)
    lay = out_layout(len(enc.names), dev["pe_peak"].shape[1], dev["mem_bw"].shape[1], 1,
                     len(enc.wl_names))
    before = phase_sim_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        phase_sim_cuda(enc.on("cpu"), dev, ops.pack_nocs(dev), torch.empty(2, lay["width"]))
    assert phase_sim_cuda.launches == before


def test_single_design_matches_scalar_simulator():
    """The plain version prices a design as the scalar simulator does
    (the port's own oracle chain: rows → plain version ≡ simulate)."""
    import repro_torch.core as P

    from _torch_helpers import to_port

    rg = R.ar_complex()
    pg = P.ar_complex()
    db = P.HardwareDatabase()
    designs = [to_port(d) for d in R.random_single_noc_designs(rg, 4, seed=2)]
    enc = PT.EncodedWorkload.of(pg)
    rows = PT.rows_to(PT.encode_batch(designs, pg, db, enc), "cpu")
    out = PT.simulate_batch(enc, rows)
    for j, d in enumerate(designs):
        ref = P.simulate(d, pg, db)
        assert abs(out["latency_s"][j].item() - ref.latency_s) / ref.latency_s < 1e-5
        for k, n in enumerate(enc.names):
            f = ref.task_finish_s[n]
            assert abs(out["finish_s"][j, k].item() - f) / max(f, 1e-12) < 1e-5, n
