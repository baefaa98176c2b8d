"""The port's phase-sim path against the JAX package's Pallas kernel.

On the CPU the Pallas kernel runs in interpret mode (as the JAX package's own
tests run it), and the port's plain version and the kernel wrapper's CPU
path (task axis padded to whole warps) must both match it on every output
column within 1e-5 relative, integer outputs exactly. The CUDA kernel itself
runs only on a card: its tests are in ``test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from _torch_helpers import assert_outputs_close, reference_rows, workload_arrays  # noqa: E402
from repro_torch.core import phase_sim_torch as PT  # noqa: E402
from repro_torch.kernels.phase_sim import ops  # noqa: E402
from repro_torch.kernels.phase_sim.ref import phase_sim_ref  # noqa: E402

GRAPHS = {"audio": R.audio, "ar_complex": R.ar_complex}


CASES = [(name, n_noc, batch) for name in GRAPHS for n_noc in (1, 2, 3) for batch in (1, 8)]
# one B = 64 case: interpret mode costs seconds a case (the XLA comparison in
# test_torch_phase_sim.py covers B = 64 on every graph and chain depth)
CASES.append(pytest.param("ar_complex", 3, 64, marks=pytest.mark.slow))


@pytest.mark.parametrize("name,n_noc,batch", CASES)
def test_plain_matches_pallas_kernel_interpret(name, n_noc, batch):
    import jax

    from repro.kernels.phase_sim import phase_sim

    renc, rows = reference_rows(GRAPHS[name](), n_noc, batch, seed=7 * n_noc + batch)
    want = jax.jit(lambda r: phase_sim(renc, r, interpret=True))(rows)
    want = {k: np.asarray(v) for k, v in want.items()}
    enc, dev = PT.from_reference(workload_arrays(renc), renc.names, renc.wl_names, rows, "cpu")
    assert_outputs_close(phase_sim_ref(enc, dev), want, (name, n_noc, batch, "plain"))
    assert_outputs_close(ops.phase_sim(enc, dev), want, (name, n_noc, batch, "wrapper"))
