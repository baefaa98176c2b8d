"""The port's threefry draws (``repro_torch.core.prng``) against
``jax.random`` under the JAX package's defaults: keys, splits, fold-ins,
uniforms and categorical draws at the chain block's shapes, bit for bit.
Also the SA temperature schedule of the chain block against the reference's
compiled f32 arithmetic."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.phase_sim_jax import EncodedDesign as RED  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.device_explore import temperatures  # noqa: E402

SEEDS = (0, 1, 3, 7, 12345, 2**31 - 1)


def jax_keys(seed, n):
    import jax
    import jax.numpy as jnp

    base = jax.random.PRNGKey(seed)
    return np.asarray(jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    import jax

    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)).astype(np.int64),
                          prng.prng_key(seed).numpy())
    want = jax_keys(seed, 300)
    got = prng.fold_in(prng.prng_key(seed), torch.arange(300))
    assert got.dtype == torch.int64
    assert np.array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_split_three_matches_jax(seed):
    import jax

    keys = jax_keys(seed, 64)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
    got = prng.split(torch.from_numpy(keys.astype(np.int64)), 3)
    assert got.shape == (64, 3, 2)
    assert np.array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed):
    """The accept test's scalar f32 uniform per chain, and the Gumbel
    sampler's (M,) uniforms on [tiny, 1)."""
    import jax
    import jax.numpy as jnp

    keys = jax_keys(seed, 256)
    kt = torch.from_numpy(keys.astype(np.int64))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))(keys))
    got = prng.uniform(kt)
    assert got.dtype == torch.float32 and got.shape == (256,)
    assert np.array_equal(want, got.numpy())
    tiny = float(np.finfo(np.float32).tiny)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (333,), jnp.float32, minval=tiny, maxval=1.0))(keys))
    assert np.array_equal(want, prng.uniform(kt, (333,), tiny, 1.0).numpy())


def _chain_table_width(graph, alloc):
    rg = getattr(R, graph)()
    db = R.HardwareDatabase()
    enc = R.DeviceChainRunner(rg, db).enc
    d = R.random_single_noc_designs(rg, 1, seed=7)[0]
    return R.MoveTable.of(RED.of(d, rg, db, enc), enc, alloc=alloc).n_moves


@pytest.mark.parametrize("graph,alloc", [("audio", False), ("audio", True),
                                         ("ar_complex", False), ("ar_complex", True)])
@pytest.mark.parametrize("masked", [False, True])
def test_categorical_matches_jax_at_chain_shapes(graph, alloc, masked):
    """One draw per chain over the move table's M rows, as the block draws
    it: log-weight logits, with the invalid rows at -1e30 (a chain whose
    every row is masked draws row 0, the first of the ties)."""
    import jax

    m = _chain_table_width(graph, alloc)
    r = 64
    keys = jax_keys(11, r)
    rng = np.random.default_rng(m)
    logits = np.log(rng.uniform(0.0, 1e-3, (r, m)) + 1e-6).astype(np.float32)
    if masked:
        logits[rng.random((r, m)) < 0.7] = np.float32(-1e30)
        logits[0] = np.float32(-1e30)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = prng.categorical(torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(logits))
    assert np.array_equal(want, got.numpy())
    if masked:
        assert int(got[0]) == 0


@pytest.mark.parametrize("t0,decay", [(0.05, 0.997), (0.05, 0.99), (0.3, 0.95)])
def test_temperatures_match_reference_schedule(t0, decay):
    """``t0 · decay^it`` in f32 as the reference's compiled block computes
    it, for every iteration up to 6000 (denormal results flushed)."""
    import jax
    import jax.numpy as jnp

    its = np.arange(0, 6000, dtype=np.int32)
    want = np.asarray(jax.jit(
        lambda it: jnp.float32(t0) * jnp.float32(decay) ** it.astype(jnp.float32))(its))
    assert np.array_equal(want, temperatures(t0, decay, 0, 6000))
    assert np.array_equal(want[100:132], temperatures(t0, decay, 100, 32))


def test_draws_are_device_independent_in_form():
    """Keys stay int64 words below 2^32 through every call."""
    k = prng.split(prng.fold_in(prng.prng_key(5), torch.arange(8)), 3)
    assert k.dtype == torch.int64 and int(k.min()) >= 0 and int(k.max()) < 2**32
    assert P.ChainCarry._fields[3] == "key"
