"""plmDCA: loss/grad vs oracle, L-BFGS sanity, tiny end-to-end fit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from pydca_tpu import stats
from pydca_tpu.ops.lbfgs import lbfgs_minimize
from pydca_tpu.plm import PlmDCA, fit_plm, init_params, plm_loss_and_grad
from pydca_tpu.alphabets import RNA
from pydca_tpu.io.fasta import MSA


def small_msa(n=60, l=8, q=5, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, size=(4, l))
    msa = base[rng.integers(0, 4, size=n)]
    mut = rng.random((n, l)) < 0.3
    msa = np.where(mut, rng.integers(0, q, size=(n, l)), msa)
    _, idx = np.unique(msa, axis=0, return_index=True)
    return msa[np.sort(idx)].astype(np.int32)


def test_plm_loss_and_grad_vs_oracle():
    q = 5
    msa = small_msa(q=q)
    n, l = msa.shape
    w = oracle.seq_weights(msa, 0.8)
    rng = np.random.default_rng(0)
    d = l * q + l * (l - 1) // 2 * q * q
    theta = rng.normal(scale=0.1, size=d)
    lam_h, lam_j = 1.4, 1.4

    fx_ref, g_ref = oracle.plm_loss_and_grad(theta, msa, w, lam_h, lam_j, q)

    pidx = jnp.asarray(stats.pair_index_matrix(l))
    fx, g = plm_loss_and_grad(
        jnp.asarray(theta),
        jnp.asarray(msa),
        jnp.asarray(w),
        pidx,
        jnp.float64(lam_h),
        jnp.float64(lam_j),
        l,
        q,
    )
    assert float(fx) == pytest.approx(fx_ref, rel=1e-9)
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-7, atol=1e-9)


def test_lbfgs_quadratic():
    # min 0.5 x'Ax - b'x with SPD A: solution A^{-1} b
    rng = np.random.default_rng(1)
    d = 20
    a = rng.normal(size=(d, d))
    A = a @ a.T + d * np.eye(d)
    b = rng.normal(size=d)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)

    def fun(x):
        g = Aj @ x - bj
        return 0.5 * x @ Aj @ x - bj @ x, g

    res = lbfgs_minimize(
        fun, jnp.zeros(d), max_iterations=200, epsilon=1e-8, max_linesearch=20
    )
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(A, b), atol=1e-5)
    # Near float rounding the Armijo search can fail before the gradient
    # criterion fires; like the reference (plmdcaBackend.cpp:82-90 treats
    # LBFGSERR_ROUNDING_ERROR as completion) both count as successful.
    assert bool(res.converged) or bool(res.linesearch_failed)


def test_lbfgs_rosenbrock():
    def fun(x):
        val = (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2
        g = jnp.array(
            [
                -2 * (1 - x[0]) - 400 * x[0] * (x[1] - x[0] ** 2),
                200 * (x[1] - x[0] ** 2),
            ]
        )
        return val, g

    res = lbfgs_minimize(
        fun,
        jnp.array([-1.2, 1.0]),
        max_iterations=500,
        epsilon=1e-8,
        max_linesearch=30,
    )
    np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0], atol=1e-4)


def test_fit_plm_descends_and_is_symmetricly_regularized():
    q = 5
    msa = small_msa(q=q)
    n, l = msa.shape
    w = jnp.asarray(oracle.seq_weights(msa, 0.8), jnp.float32)
    lam = jnp.float32(0.2 * (l - 1))
    msa_j = jnp.asarray(msa)

    theta0 = init_params(msa_j, w, l, q)
    pidx = jnp.asarray(stats.pair_index_matrix(l))
    f0, _ = plm_loss_and_grad(theta0, msa_j, w, pidx, lam, lam, l, q)

    res = fit_plm(msa_j, w, lam, lam, l, q, max_iterations=50)
    assert float(res.fx) < float(f0)
    assert int(res.num_iters) > 0


def test_init_params_matches_reference_formula():
    q = 5
    msa = small_msa(q=q)
    l = msa.shape[1]
    w = oracle.seq_weights(msa, 0.8)
    theta0 = np.asarray(init_params(jnp.asarray(msa), jnp.asarray(w), l, q))
    # oracle: h = log(weighted_count + 1) centered per site; J = 0
    fi = oracle.single_site_freqs(msa, w, q)
    h = np.log(fi * w.sum() + 1.0)
    h -= h.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(theta0[: l * q], h.reshape(-1), rtol=1e-5, atol=1e-6)
    assert np.all(theta0[l * q :] == 0)


def test_plmdca_engine_end_to_end():
    q = 5
    data = small_msa(n=80, l=10, q=q, seed=11).astype(np.int8)
    inst = PlmDCA(MSA(data=data, alphabet=RNA), "rna", max_iterations=30)
    l = data.shape[1]
    p = l * (l - 1) // 2

    params = inst.get_fields_and_couplings_from_backend()
    assert params.shape == (l * q + p * q * q,)
    assert params.dtype == np.float32

    fn = inst.compute_sorted_FN()
    fn_apc = inst.compute_sorted_FN_APC()
    di = inst.compute_sorted_DI()
    assert len(fn) == len(fn_apc) == len(di) == p
    for scores in (fn, fn_apc, di):
        vals = [s for _, s in scores]
        assert vals == sorted(vals, reverse=True)

    fields, ranked = inst.compute_params(linear_dist=2, num_site_pairs=4)
    assert len(fields) == l
    assert 0 < len(ranked) <= 4


def test_chunked_loss_and_grad_matches_full():
    import numpy as np
    import jax.numpy as jnp
    from pydca_tpu import stats
    from pydca_tpu.plm import (
        _pad_to_blocks,
        plm_loss_and_grad,
        plm_loss_and_grad_chunked,
    )

    rng = np.random.default_rng(3)
    n, l, q = 37, 9, 5
    msa = jnp.asarray(rng.integers(0, q, (n, l)), jnp.int32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    d = l * q + (l * (l - 1) // 2) * q * q
    theta = jnp.asarray(rng.normal(scale=0.1, size=d), jnp.float32)
    pidx = jnp.asarray(stats.pair_index_matrix(l))
    lam = jnp.float32(1.3)

    f_full, g_full = plm_loss_and_grad(theta, msa, w, pidx, lam, lam, l, q)
    mb, wb = _pad_to_blocks(np.asarray(msa), w, 8)  # 37 -> 5 blocks of 8
    f_chk, g_chk = plm_loss_and_grad_chunked(theta, mb, wb, pidx, lam, lam, l, q)
    np.testing.assert_allclose(float(f_chk), float(f_full), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(g_chk), np.asarray(g_full), rtol=1e-4, atol=1e-4
    )


def test_fit_plm_seq_block_matches_full():
    import numpy as np
    import jax.numpy as jnp
    from pydca_tpu.plm import fit_plm

    rng = np.random.default_rng(4)
    n, l, q = 50, 8, 5
    msa = rng.integers(0, q, (n, l)).astype(np.int32)
    w = jnp.ones((n,), jnp.float32)
    lam = jnp.float32(0.2 * (l - 1))
    r1 = fit_plm(jnp.asarray(msa), w, lam, lam, l, q, max_iterations=15)
    r2 = fit_plm(
        jnp.asarray(msa), w, lam, lam, l, q, max_iterations=15, seq_block=16
    )
    # full-batch runs the fused direction loop, streaming the generic one:
    # same math, different float schedules, so iterates agree to tolerance
    # (not bitwise) and iteration counts may differ by a rounding exit
    assert abs(int(r2.num_iters) - int(r1.num_iters)) <= 3
    np.testing.assert_allclose(float(r2.fx), float(r1.fx), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(r2.x), np.asarray(r1.x), rtol=2e-3, atol=2e-3
    )


def test_chunked_loss_bf16_close_to_f32():
    """The streaming path honors mm_bf16 (VERDICT r2: it used to drop it)."""
    import numpy as np
    import jax.numpy as jnp
    from pydca_tpu import stats
    from pydca_tpu.plm import _pad_to_blocks, plm_loss_and_grad_chunked

    rng = np.random.default_rng(7)
    n, l, q = 24, 7, 5
    msa = rng.integers(0, q, (n, l)).astype(np.int32)
    w = jnp.asarray(rng.random(n), jnp.float32)
    d = l * q + (l * (l - 1) // 2) * q * q
    theta = jnp.asarray(rng.normal(scale=0.1, size=d), jnp.float32)
    pidx = jnp.asarray(stats.pair_index_matrix(l))
    lam = jnp.float32(1.3)

    mb, wb = _pad_to_blocks(msa, w, 8)
    f32, g32 = plm_loss_and_grad_chunked(theta, mb, wb, pidx, lam, lam, l, q)
    f16, g16 = plm_loss_and_grad_chunked(
        theta, mb, wb, pidx, lam, lam, l, q, mm_bf16=True
    )
    # bf16 operands, f32 accumulation: ~1e-2 relative agreement expected
    np.testing.assert_allclose(float(f16), float(f32), rtol=2e-2)
    cos = float(
        jnp.vdot(g16, g32) / (jnp.linalg.norm(g16) * jnp.linalg.norm(g32))
    )
    assert cos > 0.999


def test_resolve_precision():
    from pydca_tpu.plm import PlmDCAException, resolve_precision

    assert resolve_precision("bfloat16") is True
    assert resolve_precision("bf16") is True
    assert resolve_precision("float32") is False
    assert resolve_precision("f32") is False
    # on the CPU test backend "auto" resolves to float32
    assert resolve_precision(None) is False
    assert resolve_precision("auto") is False
    import pytest as _pytest

    with _pytest.raises(PlmDCAException):
        resolve_precision("float16")


def test_fit_plm_recovers_from_device_error_via_checkpoint(tmp_path, monkeypatch):
    """Elastic recovery: a RuntimeError mid-chunk resumes from the last
    checkpoint instead of losing the run (SURVEY section 5, failure
    detection/recovery)."""
    import numpy as np
    import jax.numpy as jnp
    from pydca_tpu import plm as plm_mod

    rng = np.random.default_rng(31)
    n, l, q = 40, 8, 5
    msa = jnp.asarray(rng.integers(0, q, (n, l)), jnp.int32)
    w = jnp.ones((n,), jnp.float32)
    lam = jnp.float32(0.2 * (l - 1))
    ckpt = str(tmp_path / "fit.npz")

    ref = plm_mod.fit_plm(msa, w, lam, lam, l, q, max_iterations=20, chunk_size=5)

    # the full-batch fit runs the fused chunk program
    orig = plm_mod._plm_fused_steps
    fail_at = {"calls": 0}

    def flaky(*args, **kwargs):
        fail_at["calls"] += 1
        if fail_at["calls"] == 3:  # fail on the third chunk
            raise RuntimeError("ABORTED: device error (synthetic)")
        return orig(*args, **kwargs)

    monkeypatch.setattr(plm_mod, "_plm_fused_steps", flaky)
    res = plm_mod.fit_plm(
        msa, w, lam, lam, l, q,
        max_iterations=20, chunk_size=5,
        checkpoint_path=ckpt, checkpoint_every=5,
    )
    assert int(res.num_iters) == int(ref.num_iters)
    np.testing.assert_allclose(float(res.fx), float(ref.fx), rtol=1e-6)

    # without a checkpoint the error propagates
    fail_at["calls"] = 0
    import pytest as _pytest

    with _pytest.raises(RuntimeError, match="synthetic"):
        plm_mod.fit_plm(
            msa, w, lam, lam, l, q, max_iterations=20, chunk_size=5
        )


def test_seq_block_keeps_mesh(monkeypatch, tmp_path):
    """Streaming (seq_block) now COMPOSES with the mesh (VERDICT r3 item 1):
    the engine must keep the resolved mesh instead of dropping to one chip."""
    import numpy as np
    from pydca_tpu.io.fasta import MSA
    from pydca_tpu.alphabets import RNA
    from pydca_tpu.plm import PlmDCA

    rng = np.random.default_rng(5)
    msa = MSA(
        data=rng.integers(0, 5, (30, 10)).astype(np.int8), alphabet=RNA
    )
    # explicit seq_block + auto mesh on the 8-device test backend
    inst = PlmDCA(msa, "rna", seq_block=8, mesh="auto", max_iterations=5)
    assert inst._PlmDCA__mesh is not None
    # and the streaming fit itself runs sharded end-to-end
    params = inst.get_fields_and_couplings_from_backend()
    assert np.isfinite(params).all()
    # without seq_block the mesh resolves too
    inst2 = PlmDCA(msa, "rna", mesh="auto", max_iterations=5)
    assert inst2._PlmDCA__mesh is not None


def test_compact_direction_matches_two_loop():
    """The compact-representation direction must equal the two-loop
    recursion (Byrd-Nocedal-Schnabel equivalence) for partial, full, and
    wrapped circular histories."""
    from pydca_tpu.ops.lbfgs import _two_loop, _two_loop_reference

    rng = np.random.default_rng(0)
    d, m = 400, 5
    for k in (0, 1, 3, 5, 7, 23):
        s_hist = np.zeros((m, d))
        y_hist = np.zeros((m, d))
        rho = np.zeros(m)
        for t in range(max(0, k - m), k):
            slot = t % m
            s = rng.normal(size=d)
            y = s * rng.uniform(0.5, 2.0) + 0.1 * rng.normal(size=d)
            if s @ y <= 0:
                y = s  # keep curvature positive
            s_hist[slot] = s
            y_hist[slot] = y
            rho[slot] = 1.0 / (s @ y)
        g = rng.normal(size=d)
        args = (
            jnp.asarray(g), jnp.asarray(s_hist), jnp.asarray(y_hist),
            jnp.asarray(rho), jnp.asarray(k, jnp.int32), m,
        )
        ref = np.asarray(_two_loop_reference(*args))
        got = np.asarray(_two_loop(*args))
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-10,
                                   err_msg=f"k={k}")


def test_direction_coeffs_matches_two_loop():
    """The scalar-coefficient direction (fused loop) must reproduce the
    compact-representation / two-loop direction exactly: d = -(gamma*g +
    Z.T @ c) with (gamma, c) from cached Gram projections only."""
    from pydca_tpu.ops.lbfgs import _two_loop, direction_coeffs

    rng = np.random.default_rng(11)
    dsz, m = 300, 5
    for k in (0, 1, 3, 5, 9, 17):
        s_hist = np.zeros((m, dsz))
        y_hist = np.zeros((m, dsz))
        rho = np.zeros(m)
        for t in range(max(0, k - m), k):
            slot = t % m
            s = rng.normal(size=dsz)
            y = s * rng.uniform(0.5, 2.0) + 0.1 * rng.normal(size=dsz)
            if s @ y <= 0:
                y = s
            s_hist[slot] = s
            y_hist[slot] = y
            rho[slot] = 1.0 / (s @ y)
        g = rng.normal(size=dsz)
        z = np.concatenate([s_hist, y_hist], axis=0)
        zg = jnp.asarray(z @ g)
        zzt = jnp.asarray(z @ z.T)
        gg = jnp.asarray(g @ g)
        gamma, c, dg0, dn2 = direction_coeffs(
            zg, zzt, gg, jnp.asarray(k, jnp.int32), m
        )
        d = -(np.asarray(gamma) * g + np.asarray(c) @ z)
        ref = np.asarray(
            _two_loop(
                jnp.asarray(g), jnp.asarray(s_hist), jnp.asarray(y_hist),
                jnp.asarray(rho), jnp.asarray(k, jnp.int32), m,
            )
        )
        np.testing.assert_allclose(d, ref, rtol=1e-9, atol=1e-10,
                                   err_msg=f"k={k}")
        # the scalar estimates agree with direct evaluation
        np.testing.assert_allclose(float(dg0), float(g @ d), rtol=1e-6)
        np.testing.assert_allclose(float(dn2), float(d @ d), rtol=1e-6)


def test_wolfe_scalar_matches_vector_linesearch():
    """wolfe_scalar must accept the same steps as the vector-space search
    on a 1-D objective where phi is evaluated exactly."""
    from pydca_tpu.ops.lbfgs import _wolfe_linesearch, wolfe_scalar

    # phi(a) = (a - 2)^2 along d = 1 from x = 0: minimum at a = 2
    def phi(a):
        return (a - 2.0) ** 2, 2.0 * (a - 2.0)

    f0 = jnp.float32(4.0)
    dg0 = jnp.float32(-4.0)
    a, f_new, took, rounding, trials = wolfe_scalar(
        phi, f0, dg0, jnp.float32(1.0), jnp.float32(1e-4), jnp.float32(0.9),
        10,
    )
    assert bool(took) and not bool(rounding)
    # strong-Wolfe point for this parabola: |phi'(a)| <= 0.9*|phi'(0)|
    assert abs(2.0 * (float(a) - 2.0)) <= 0.9 * 4.0 + 1e-6
    assert float(f_new) < 4.0

    def fun(x):
        v = (x[0] - 2.0) ** 2
        return v, jnp.array([2.0 * (x[0] - 2.0)])

    x0 = jnp.zeros(1, jnp.float32)
    g0 = jnp.array([-4.0], jnp.float32)
    xv, fv, gv, tookv, roundv, trialsv = _wolfe_linesearch(
        fun, x0, f0, g0, jnp.ones(1, jnp.float32), dg0, jnp.float32(1.0),
        jnp.float32(1e-4), jnp.float32(0.9), 10,
    )
    assert bool(tookv)
    np.testing.assert_allclose(float(xv[0]), float(a), rtol=1e-6)
    np.testing.assert_allclose(float(fv), float(f_new), rtol=1e-6)
    assert int(trialsv) == int(trials)
