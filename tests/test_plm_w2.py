"""w2-space ("z-space") plmDCA optimization (r4).

L-BFGS over the full symmetric coupling matrix w2 — the logits-matmul
operand itself — deletes the per-evaluation compact->w2 expansion and its
VJP.
These tests pin the math: the subspace restriction is exact (same loss,
projected gradient), the conversions are lossless, and the end-to-end fit
reaches the same optimum as the compact path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pydca_tpu import stats
from pydca_tpu import plm as plm_mod
from pydca_tpu.plm import (
    _plm_loss_prepped,
    _plm_loss_w2_prepped,
    _prep_msa,
    fit_plm,
    plm_loss_and_grad_w2_chunked,
    theta_to_z,
    z_to_theta,
)


def _toy(n=60, l=9, q=5, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, (4, l))
    msa = base[rng.integers(0, 4, n)]
    mut = rng.random((n, l)) < 0.25
    return np.where(mut, rng.integers(0, q, (n, l)), msa).astype(np.int32)


def _random_theta(l, q, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    d = l * q + (l * (l - 1) // 2) * q * q
    return jnp.asarray(rng.normal(scale=scale, size=d), jnp.float32)


def test_theta_z_roundtrip():
    l, q = 11, 5
    theta = _random_theta(l, q)
    back = z_to_theta(theta_to_z(theta, l, q), l, q)
    np.testing.assert_allclose(np.asarray(back), np.asarray(theta), rtol=1e-6)


def test_w2_loss_matches_compact_loss():
    q = 5
    msa = _toy(q=q)
    n, l = msa.shape
    m = jnp.asarray(msa)
    w = jnp.asarray(np.random.default_rng(1).random(n), jnp.float32)
    lam = jnp.float32(1.7)
    theta = _random_theta(l, q, seed=2)
    x3, maskq = _prep_msa(m, l, q, jnp.float32)
    x = x3.reshape(-1, l * q)  # w2-space losses take the 2-D one-hot
    xa = maskq.astype(jnp.float32).reshape(-1, q * l)

    f_compact = _plm_loss_prepped(theta, x3, maskq, w, lam, lam, l, q)
    z = theta_to_z(theta, l, q)
    f_w2 = _plm_loss_w2_prepped(z, x, xa, maskq, w, lam, lam, l, q)
    np.testing.assert_allclose(float(f_w2), float(f_compact), rtol=1e-6)


def test_w2_gradient_is_exact_subspace_projection():
    """g_z must be the exact subspace gradient: h parts equal the compact
    gradient; each coupling slot carries exactly HALF the compact J
    gradient (the pair is duplicated across two slots); and g_z is
    symmetric with zero diagonal blocks."""
    q = 5
    msa = _toy(q=q, seed=5)
    n, l = msa.shape
    m = jnp.asarray(msa)
    w = jnp.asarray(np.random.default_rng(2).random(n), jnp.float32)
    lam = jnp.float32(1.1)
    theta = _random_theta(l, q, seed=4)
    x3, maskq = _prep_msa(m, l, q, jnp.float32)
    x = x3.reshape(-1, l * q)  # w2-space losses take the 2-D one-hot
    xa = maskq.astype(jnp.float32).reshape(-1, q * l)

    g_compact = jax.grad(_plm_loss_prepped)(
        theta, x3, maskq, w, lam, lam, l, q
    )
    z = theta_to_z(theta, l, q)
    g_z = jax.grad(_plm_loss_w2_prepped)(
        z, x, xa, maskq, w, lam, lam, l, q
    )
    # h gradients identical
    np.testing.assert_allclose(
        np.asarray(g_z[: l * q]), np.asarray(g_compact[: l * q]),
        rtol=1e-5, atol=1e-6,
    )
    # coupling slots: z_to_theta averages the two mirrored slots, each of
    # which holds half the compact gradient
    g_z_as_theta = z_to_theta(g_z, l, q)
    np.testing.assert_allclose(
        2.0 * np.asarray(g_z_as_theta[l * q :]),
        np.asarray(g_compact[l * q :]),
        rtol=1e-4, atol=1e-5,
    )
    # symmetry + zero diagonal blocks (iterates must stay in the subspace)
    g4 = np.asarray(g_z[l * q :]).reshape(l, q, q, l)
    np.testing.assert_allclose(
        g4, g4.transpose(3, 2, 1, 0), rtol=1e-5, atol=1e-7
    )
    assert np.abs(np.einsum("iabi->iab", g4)).max() < 1e-7


def test_w2_chunked_matches_w2_full():
    q = 5
    msa = _toy(n=37, l=8, q=q, seed=6)
    n, l = msa.shape
    m = jnp.asarray(msa)
    w = jnp.asarray(np.random.default_rng(3).random(n), jnp.float32)
    lam = jnp.float32(1.3)
    theta = _random_theta(l, q, seed=7)
    z = theta_to_z(theta, l, q)
    x3, maskq = _prep_msa(m, l, q, jnp.float32)
    x = x3.reshape(-1, l * q)  # w2-space losses take the 2-D one-hot
    xa = maskq.astype(jnp.float32).reshape(-1, q * l)

    f_full, g_full = jax.value_and_grad(_plm_loss_w2_prepped)(
        z, x, xa, maskq, w, lam, lam, l, q
    )
    mb, wb = plm_mod._pad_to_blocks(msa, w, 8)
    f_chk, g_chk = plm_loss_and_grad_w2_chunked(z, mb, wb, lam, lam, l, q)
    np.testing.assert_allclose(float(f_chk), float(f_full), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(g_chk), np.asarray(g_full), rtol=1e-4, atol=1e-5
    )


def test_fit_w2_reaches_compact_optimum():
    """Strictly convex objective: both parameterizations converge to the
    same unique optimum (trajectories differ — different inner-product
    geometry — so compare near convergence, not per-iteration)."""
    q = 5
    msa = _toy(n=80, l=8, q=q, seed=8)
    n, l = msa.shape
    m = jnp.asarray(msa)
    w = jnp.ones((n,), jnp.float32)
    lam = jnp.float32(0.2 * (l - 1))
    r_c = fit_plm(m, w, lam, lam, l, q, max_iterations=300,
                  param_space="compact")
    r_z = fit_plm(m, w, lam, lam, l, q, max_iterations=300, param_space="w2")
    assert r_z.x.shape == r_c.x.shape  # converted back to compact layout
    np.testing.assert_allclose(float(r_z.fx), float(r_c.fx), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(r_z.x), np.asarray(r_c.x), rtol=1e-2, atol=2e-3
    )


def test_fit_w2_streaming():
    q = 5
    msa = _toy(n=50, l=8, q=q, seed=9)
    n, l = msa.shape
    m = jnp.asarray(msa)
    w = jnp.ones((n,), jnp.float32)
    lam = jnp.float32(0.2 * (l - 1))
    r_full = fit_plm(m, w, lam, lam, l, q, max_iterations=15,
                     param_space="w2")
    r_str = fit_plm(m, w, lam, lam, l, q, max_iterations=15, seq_block=16,
                    param_space="w2")
    assert int(r_str.num_iters) == int(r_full.num_iters)
    np.testing.assert_allclose(float(r_str.fx), float(r_full.fx), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(r_str.x), np.asarray(r_full.x), rtol=2e-3, atol=2e-3
    )


def test_checkpoint_space_wins_on_resume(tmp_path):
    """A compact-space checkpoint forces the resumed fit back to compact
    (history vectors cannot be converted between spaces)."""
    q = 5
    msa = _toy(n=40, l=7, q=q, seed=10)
    n, l = msa.shape
    m = jnp.asarray(msa)
    w = jnp.ones((n,), jnp.float32)
    lam = jnp.float32(0.2 * (l - 1))
    ck = str(tmp_path / "fit.npz")
    r1 = fit_plm(m, w, lam, lam, l, q, max_iterations=6, chunk_size=3,
                 checkpoint_path=ck, checkpoint_every=3,
                 param_space="compact")
    # resume asking for w2: must continue in compact space and still work
    r2 = fit_plm(m, w, lam, lam, l, q, max_iterations=12, chunk_size=3,
                 checkpoint_path=ck, checkpoint_every=3, param_space="w2")
    d = l * q + (l * (l - 1) // 2) * q * q
    assert r2.x.shape == (d,)
    assert int(r2.num_iters) >= int(r1.num_iters)
    assert float(r2.fx) <= float(r1.fx) + 1e-6
