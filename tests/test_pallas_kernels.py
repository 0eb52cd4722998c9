"""The identity-count kernel vs a brute-force count, and its dispatch.

The kernel runs here in Pallas interpret mode; its compiled form needs a
GPU and is covered by the ``gpu``-marked test (and by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pydca_tpu import stats
from pydca_tpu.ops import pallas_kernels as pk

# small tiles so every case spans several row and column blocks
SMALL = pk.IdentityTiles(block_i=32, block_j=16, block_k=32)


def _clustered(n, l, q, seed):
    from pydca_tpu.synthetic import clustered_codes

    return clustered_codes(n, l, q, seed=seed, clusters=6)


def _brute(rows, thr, valid=None, cols=None):
    cols = rows if cols is None else cols
    ident = (rows[:, None, :] == cols[None, :, :]).sum(-1)
    hit = ident > np.float32(thr)
    if valid is not None:
        hit &= valid[None, :]
    return hit.sum(1)


@pytest.mark.parametrize(
    "n,l,q,masked",
    [
        (70, 11, 5, False),
        (97, 37, 5, True),
        (133, 45, 21, False),
        (61, 29, 21, True),
        (83, 13, 5, True),
        (101, 67, 21, False),
    ],
)
def test_identity_counts_interpret(n, l, q, masked):
    """Odd N and L (padding on both axes, several site chunks), masked and
    unmasked, q in {5, 21}: exact against the brute force."""
    msa = _clustered(n, l, q, seed=n + l)
    valid = np.random.default_rng(n).random(n) > 0.3 if masked else None
    thr = 0.6 * l
    got = pk.identity_counts(
        jnp.asarray(msa), thr, q,
        None if valid is None else jnp.asarray(valid),
        tiles=SMALL, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(got), _brute(msa, thr, valid))


def test_identity_counts_rows_against_cols_interpret():
    """The data-parallel form: local rows counted against every row."""
    msa = _clustered(90, 21, 5, seed=3)
    rows = msa[30:60]
    valid = np.arange(90) < 85  # trailing shard padding
    got = pk.identity_counts(
        jnp.asarray(rows), 0.7 * 21, 5, jnp.asarray(valid),
        cols=jnp.asarray(msa), tiles=SMALL, interpret=True,
    )
    np.testing.assert_array_equal(
        np.asarray(got), _brute(rows, 0.7 * 21, valid, cols=msa)
    )


@pytest.mark.parametrize("backend,path", [("gpu", "kernel"), ("cpu", "xla")])
def test_identity_counts_dispatch_rule(monkeypatch, backend, path):
    """The GPU picks the kernel at every depth (it won at every depth timed
    on an H100); the CPU picks the blocked XLA scan."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert stats.identity_counts_path() == path


def _spy_kernel(calls):
    """Stand-in for the compiled kernel: records how production called it,
    then runs the same kernel in interpret mode on the CPU."""

    def spy(*args, **kwargs):
        calls.append(kwargs)
        kwargs.setdefault("tiles", SMALL)
        return pk.identity_counts(*args, **{**kwargs, "interpret": True})

    return spy


@pytest.mark.parametrize("n", [1, 7, 64, 300])
def test_sequence_weights_pallas_masked_dispatch(monkeypatch, n):
    """On the GPU, at any depth down to one sequence, the masked
    (shard-padded) weights go through the kernel — never in interpret
    mode — and equal the XLA masked scan."""
    rng = np.random.default_rng(12 + n)
    l, q = 9, 5
    msa = jnp.asarray(_clustered(n, l, q, seed=n), jnp.int32)
    valid = jnp.asarray(rng.random(n) > 0.25).at[0].set(True)

    w_xla = stats.sequence_weights(msa, 0.8, q, valid=valid)

    calls = []
    monkeypatch.setattr(stats, "identity_counts", _spy_kernel(calls))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    try:
        w_pl = stats.sequence_weights(msa, 0.8, q, valid=valid)
    finally:
        jax.clear_caches()  # drop the trace that captured the spy

    assert calls and all(not c.get("interpret", False) for c in calls)
    np.testing.assert_allclose(np.asarray(w_pl), np.asarray(w_xla))


def test_sequence_weights_kernel_on_data_mesh(monkeypatch):
    """Under a 'data' mesh each device counts its own rows against the
    all-gathered alignment (shard_map around the kernel); the weights equal
    the single-device XLA scan."""
    from pydca_tpu.parallel import make_mesh
    from pydca_tpu.parallel.fit import sequence_weights_sharded

    msa = jnp.asarray(_clustered(77, 14, 5, seed=5), jnp.int32)
    w_ref = np.asarray(stats.sequence_weights(msa, 0.8, 5))

    calls = []
    monkeypatch.setattr(stats, "identity_counts", _spy_kernel(calls))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    try:
        w = sequence_weights_sharded(make_mesh(4, 1), msa, 0.8, 5)
        w = np.asarray(w)
    finally:
        jax.clear_caches()

    assert calls and all("cols" in c for c in calls)
    np.testing.assert_allclose(w, w_ref)


@pytest.mark.gpu
def test_identity_counts_compiled_matches_xla(gpu):
    """The compiled Triton kernel equals the blocked XLA scan exactly."""
    msa = jnp.asarray(_clustered(20000, 120, 5, seed=9), jnp.int32)
    thr = 0.8 * 120
    got = pk.identity_counts(msa, thr, 5)
    want = stats._sequence_weights_impl(msa, jnp.float32(thr), 5, 2048)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
