"""Jittable L-BFGS with a strong-Wolfe line search, as compiled device control flow.

Replaces the reference's vendored float32 libLBFGS
(``pydca/plmdca/lbfgs/lib/lbfgs.cpp``, driven from ``plmdcaBackend.cpp:68-75``)
with a pure-JAX implementation: the search direction is computed in the
compact representation (Byrd-Nocedal-Schnabel; three ``(m, D)`` matmuls over
fixed-size history buffers — algebraically identical to the two-loop
recursion but ~60 tiny sequential kernels fewer per iteration), the whole
optimization is one
``lax.while_loop`` under ``jit``, and every objective evaluation is the
caller's traced function (for plmDCA: one large matmul plus AD).

Semantics mirrored from libLBFGS / the reference driver:
- convergence when ``||g|| / max(1, ||x||) <= epsilon``  (lbfgs.cpp progress check),
- first-iteration step ``1 / ||d||``, unit step afterwards,
- the line search enforces sufficient decrease (coefficient ``ftol = 1e-4``,
  plmdcaBackend.cpp:71) AND the strong-Wolfe curvature condition
  ``|g(x+a d).d| <= wolfe * |g(x).d|`` with ``wolfe = 0.9`` — the same pair
  of conditions MoreThuente enforces in the reference (lbfgs.cpp defaults;
  ``param.wolfe`` commented out at plmdcaBackend.cpp:74 leaves 0.9),
- bracketing + zoom with safeguarded cubic interpolation (the MoreThuente
  update rules, expressed as a single ``lax.while_loop``),
- when float32 rounding makes further decrease unresolvable, the run exits
  as *completed*, matching pydca's treatment of ``LBFGSERR_ROUNDING_ERROR``
  (= -1001) as successful completion (plmdcaBackend.cpp:82-90),
- a genuinely failed line search terminates the optimization but keeps the
  best point.

Deviation from the reference knobs: ``max_linesearch`` defaults to 10 here
(reference: 5).  Objective evaluations are far cheaper on the accelerator
than on the reference's OpenMP path, so a slightly deeper search that
avoids premature termination is the right trade; iteration-count parity is
unaffected (``max_iterations`` still counts outer iterations).

History updates with non-positive curvature ``s.y`` are skipped (standard
cautious update; the curvature condition makes them rare).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "LBFGSResult",
    "LBFGSState",
    "lbfgs_init",
    "lbfgs_steps",
    "lbfgs_minimize",
    "result_from_state",
    "direction_coeffs",
    "wolfe_scalar",
]


class LBFGSResult(NamedTuple):
    x: jax.Array
    fx: jax.Array
    gnorm: jax.Array
    num_iters: jax.Array
    converged: jax.Array  # True when gradient criterion met OR rounding-limit exit
    linesearch_failed: jax.Array
    n_evals: jax.Array  # total objective/gradient evaluations (incl. init)


class LBFGSState(NamedTuple):
    """Explicit, serializable optimizer state (a pytree of arrays).

    Exposing the state lets callers run the optimization as a sequence of
    short device programs (host-chunked), checkpoint/resume long runs, and
    log per-chunk progress — the aux subsystems the reference lacks entirely
    (SURVEY.md section 5: checkpoint/resume "none").
    """

    x: jax.Array
    f: jax.Array
    g: jax.Array
    s_hist: jax.Array  # (m, D)
    y_hist: jax.Array  # (m, D)
    rho: jax.Array  # (m,)
    k: jax.Array  # iteration counter
    done: jax.Array
    converged: jax.Array
    ls_failed: jax.Array
    n_evals: jax.Array  # objective/gradient evaluation counter


def _two_loop_reference(g, s_hist, y_hist, rho, k, m):
    """Two-loop recursion over a circular history buffer (reference form).

    Invalid slots carry rho == 0 and contribute nothing (alpha = beta = 0).
    Kept for testing: :func:`_two_loop` computes the same direction via the
    compact representation, which is what production uses.
    """
    q = g

    def bwd(idx, carry):
        q, alphas = carry
        # iterate newest -> oldest: slot (k - 1 - idx) mod m
        slot = jnp.mod(k - 1 - idx, m)
        a = rho[slot] * jnp.vdot(s_hist[slot], q)
        q = q - a * y_hist[slot]
        return q, alphas.at[slot].set(a)

    q, alphas = jax.lax.fori_loop(0, m, bwd, (q, jnp.zeros(m, g.dtype)))

    # H0 scaling gamma = s.y / y.y from the newest valid pair
    newest = jnp.mod(k - 1, m)
    sy = jnp.vdot(s_hist[newest], y_hist[newest])
    yy = jnp.vdot(y_hist[newest], y_hist[newest])
    gamma = jnp.where((k > 0) & (yy > 0), sy / jnp.maximum(yy, 1e-30), 1.0)
    r = gamma * q

    def fwd(idx, r):
        # iterate oldest -> newest: slot (k - m + idx) mod m
        slot = jnp.mod(k - m + idx, m)
        b = rho[slot] * jnp.vdot(y_hist[slot], r)
        r = r + s_hist[slot] * (alphas[slot] - b)
        return r

    r = jax.lax.fori_loop(0, m, fwd, r)
    return -r


def _two_loop(g, s_hist, y_hist, rho, k, m):
    """Compact-representation L-BFGS direction (Byrd-Nocedal-Schnabel 1994).

    Algebraically identical to the two-loop recursion with H0 = gamma*I:

        H g = gamma*g + [S, gamma*Y] M [S^T g; gamma*Y^T g],
        M   = [[R^{-T}(D + gamma*Y^T Y)R^{-1}, -R^{-T}], [-R^{-1}, 0]],

    where R is the *chronologically* upper-triangular part of S^T Y and
    D its diagonal.  The point: the recursion is 2m sequential
    slice/vdot/axpy steps (~60 tiny kernels per iteration, far above the
    traffic roofline at D=8.35M); this form is three (m, D)-by-D
    matmuls plus m x m scalar algebra, reading the history twice.

    The circular buffer is handled without gathers: chronological
    position of slot s is (s - k) mod m, and the triangular structure is
    applied as a mask in slot space; the tiny m x m system is solved
    densely.  Invalid slots (rho == 0) carry zero rows, so their
    contributions vanish; their R diagonal is padded to 1 for
    nonsingularity.
    """
    dtype = g.dtype
    slots = jnp.arange(m)
    valid = rho != 0
    pos = jnp.mod(slots - k, m)  # ascending = oldest -> newest
    tri = (pos[:, None] <= pos[None, :]) & valid[:, None] & valid[None, :]

    p = s_hist @ g  # (m,)
    q = y_hist @ g  # (m,)
    sy_mat = s_hist @ y_hist.T  # (m, m)
    yy_mat = y_hist @ y_hist.T  # (m, m)
    vv = valid[:, None] & valid[None, :]
    yy_mat = jnp.where(vv, yy_mat, jnp.zeros((), dtype))
    r_mat = jnp.where(tri, sy_mat, jnp.zeros((), dtype)) + jnp.diag(
        jnp.where(valid, jnp.zeros((), dtype), jnp.ones((), dtype))
    )
    d_vec = jnp.where(valid, jnp.diagonal(sy_mat), jnp.zeros((), dtype))

    # H0 scaling gamma = s.y / y.y from the newest valid pair
    newest = jnp.mod(k - 1, m)
    sy_n = sy_mat[newest, newest]
    yy_n = yy_mat[newest, newest]
    gamma = jnp.where((k > 0) & (yy_n > 0), sy_n / jnp.maximum(yy_n, 1e-30), 1.0)

    rinv_p = jnp.linalg.solve(r_mat, p)
    inner = d_vec * rinv_p + gamma * (yy_mat @ rinv_p) - gamma * q
    top = jnp.linalg.solve(r_mat.T, inner)
    bot = -rinv_p
    hg = gamma * g + s_hist.T @ top + gamma * (y_hist.T @ bot)
    return -hg


def direction_coeffs(zg, zzt, gg, k, m: int):
    """Compact-representation direction as scalar coefficients (no D-vectors).

    For the stacked history ``Z = [S; Y]`` ((2m, D) rows, circular slots),
    given the cached projections ``zg = Z @ g`` ((2m,)), the cached Gram
    ``zzt = Z @ Z.T`` ((2m, 2m)) and ``gg = ||g||^2``, returns
    ``(gamma_eff, cfull, dg0_est, dnorm2_est)`` such that

        d = -(gamma_eff * g + Z.T @ cfull)

    is exactly the Byrd-Nocedal-Schnabel direction :func:`_two_loop`
    computes (same H0 scaling, same chronological triangular structure) —
    but derived from m x m scalar algebra alone.  This is the traffic-lean
    form for the fused optimizer (:mod:`pydca_tpu.plm`): the history is
    read ONCE per iteration (the ``Z.T @ cfull`` matmul) instead of the
    4-5 passes of the vector-space formulation.

    The steepest-descent fallback for non-descent directions is folded in:
    when the predicted directional derivative is non-negative the
    coefficients collapse to ``gamma_eff = 1, cfull = 0`` (d = -g).
    ``dg0_est``/``dnorm2_est`` are scalar-algebra estimates; callers that
    need them to match the materialized ``d`` bit-for-bit should recompute
    with direct vdots (cancellation in float32 can bite near convergence).
    """
    dtype = zg.dtype
    p = zg[:m]
    q = zg[m:]
    sy_mat = zzt[:m, m:]
    yy_mat = zzt[m:, m:]
    slots = jnp.arange(m)
    d_diag = jnp.diagonal(sy_mat)
    valid = d_diag != 0
    pos = jnp.mod(slots - k, m)  # ascending = oldest -> newest
    tri = (pos[:, None] <= pos[None, :]) & valid[:, None] & valid[None, :]
    vv = valid[:, None] & valid[None, :]
    yy = jnp.where(vv, yy_mat, jnp.zeros((), dtype))
    r_mat = jnp.where(tri, sy_mat, jnp.zeros((), dtype)) + jnp.diag(
        jnp.where(valid, jnp.zeros((), dtype), jnp.ones((), dtype))
    )
    d_vec = jnp.where(valid, d_diag, jnp.zeros((), dtype))

    newest = jnp.mod(k - 1, m)
    sy_n = sy_mat[newest, newest]
    yy_n = yy[newest, newest]
    gamma = jnp.where((k > 0) & (yy_n > 0), sy_n / jnp.maximum(yy_n, 1e-30), 1.0)

    rinv_p = jnp.linalg.solve(r_mat, p)
    inner = d_vec * rinv_p + gamma * (yy @ rinv_p) - gamma * q
    top = jnp.linalg.solve(r_mat.T, inner)
    bot = -rinv_p
    cfull = jnp.concatenate([top, gamma * bot]).astype(dtype)

    zg_c = jnp.vdot(zg, cfull)
    dg0 = -(gamma * gg + zg_c)
    dnorm2 = gamma * gamma * gg + 2.0 * gamma * zg_c + jnp.vdot(
        cfull, zzt @ cfull
    )
    bad = dg0 >= 0
    gamma_eff = jnp.where(bad, jnp.ones((), dtype), gamma).astype(dtype)
    cfull = jnp.where(bad, jnp.zeros((), dtype), cfull)
    dg0 = jnp.where(bad, -gg, dg0)
    dnorm2 = jnp.where(bad, gg, jnp.maximum(dnorm2, 1e-30))
    return gamma_eff, cfull, dg0, dnorm2


def wolfe_scalar(phi, f0, dg0, step0, ftol, wolfe, max_linesearch: int):
    """Strong-Wolfe bracket+zoom line search over a SCALAR phi-callback.

    Same transition rules and exit semantics as :func:`_wolfe_linesearch`,
    but the carry holds only scalars — no trial parameter vectors, no
    gradient vectors.  ``phi(alpha) -> (value, derivative)`` is expected to
    be cheap (for the fused plm path: one elementwise pass over the carried
    logits, exploiting their linearity along the direction).

    Returns ``(alpha, f_new, took_step, rounding, trials)`` where ``alpha``
    is the accepted (or best-decrease fallback) step, 0 when no step was
    resolvable; ``rounding`` mirrors libLBFGS's ROUNDING_ERROR-as-completed
    exit (plmdcaBackend.cpp:82-90).
    """
    dtype = f0.dtype
    eps_f = jnp.array(10.0 * jnp.finfo(jnp.float32).eps, dtype)
    zero = jnp.array(0.0, dtype)

    def suff(alpha, fa):
        return fa <= f0 + ftol * alpha * dg0

    def curv(dga):
        return jnp.abs(dga) <= wolfe * jnp.abs(dg0)

    def cond(c):
        (stage, alpha, lo, f_lo, dg_lo, hi, f_hi, dg_hi, best_a, best_f,
         accepted, trials, min_fgap) = c
        width_ok = jnp.where(
            stage == 1,
            jnp.abs(hi - lo) > 1e-10 * jnp.maximum(jnp.abs(hi), 1.0),
            True,
        )
        return (~accepted) & (trials < max_linesearch) & width_ok & (alpha > 0)

    def body(c):
        (stage, alpha, lo, f_lo, dg_lo, hi, f_hi, dg_hi, best_a, best_f,
         accepted, trials, min_fgap) = c
        fnew, dgnew = phi(alpha)
        fnew = fnew.astype(dtype)
        dgnew = dgnew.astype(dtype)
        trials = trials + 1
        min_fgap = jnp.minimum(min_fgap, fnew - f0)

        ok_suff = suff(alpha, fnew)
        ok_curv = curv(dgnew)
        accept_now = ok_suff & ok_curv

        better = (fnew < best_f) | accept_now
        best_a = jnp.where(better, alpha, best_a)
        new_best_f = jnp.where(better, fnew, best_f)

        is_bracket = stage == 0
        br_to_zoom_hi = (~ok_suff) | ((fnew >= f_lo) & (trials > 1))
        br_to_zoom_rev = ok_suff & (~ok_curv) & (dgnew >= 0)
        br_expand = ok_suff & (~ok_curv) & (dgnew < 0)

        zm_shrink_hi = (~ok_suff) | (fnew >= f_lo)
        zm_flip = ok_suff & (fnew < f_lo) & (dgnew * (hi - lo) >= 0)

        n_stage = jnp.where(is_bracket & (br_to_zoom_hi | br_to_zoom_rev),
                            1, stage)
        n_lo = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_rev | br_expand, alpha, lo),
            jnp.where(zm_shrink_hi, lo, alpha),
        )
        n_f_lo = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_rev | br_expand, fnew, f_lo),
            jnp.where(zm_shrink_hi, f_lo, fnew),
        )
        n_dg_lo = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_rev | br_expand, dgnew, dg_lo),
            jnp.where(zm_shrink_hi, dg_lo, dgnew),
        )
        n_hi = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_hi, alpha, jnp.where(br_to_zoom_rev, lo, hi)),
            jnp.where(zm_shrink_hi, alpha, jnp.where(zm_flip, lo, hi)),
        )
        n_f_hi = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_hi, fnew, jnp.where(br_to_zoom_rev, f_lo, f_hi)),
            jnp.where(zm_shrink_hi, fnew, jnp.where(zm_flip, f_lo, f_hi)),
        )
        n_dg_hi = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_hi, dgnew, jnp.where(br_to_zoom_rev, dg_lo, dg_hi)),
            jnp.where(zm_shrink_hi, dgnew, jnp.where(zm_flip, dg_lo, dg_hi)),
        )

        lo_b = jnp.minimum(n_lo, n_hi)
        hi_b = jnp.maximum(n_lo, n_hi)
        interp = _cubic_step(n_lo, n_f_lo, n_dg_lo, n_hi, n_f_hi, n_dg_hi,
                             lo_b, hi_b)
        n_alpha = jnp.where(
            is_bracket & br_expand,
            jnp.minimum(alpha * 2.1, jnp.array(1e20, dtype)),
            interp,
        )
        return (n_stage, n_alpha, n_lo, n_f_lo, n_dg_lo, n_hi, n_f_hi,
                n_dg_hi, best_a, new_best_f, accepted | accept_now, trials,
                min_fgap)

    init = (
        jnp.array(0, jnp.int32),
        step0.astype(dtype),
        zero, f0, dg0.astype(dtype),
        zero, f0, dg0.astype(dtype),
        zero, f0,
        jnp.array(False),
        jnp.array(0, jnp.int32),
        jnp.array(jnp.inf, dtype),
    )
    (stage, alpha, lo, f_lo, dg_lo, hi, f_hi, dg_hi, best_a, best_f,
     accepted, trials, min_fgap) = jax.lax.while_loop(cond, body, init)

    decreased = best_f < f0
    took_step = accepted | decreased
    rounding = (~took_step) & (min_fgap <= eps_f * jnp.abs(f0))
    alpha_out = jnp.where(took_step, best_a, zero)
    f_out = jnp.where(took_step, best_f, f0)
    return alpha_out, f_out, took_step, rounding, trials


def _cubic_step(a, fa, da, b, fb, db, lo, hi):
    """Safeguarded cubic-Hermite minimizer of the interval, clipped to
    the central 80% of [lo, hi]; bisection fallback when degenerate."""
    d1 = da + db - 3.0 * (fa - fb) / jnp.where(a == b, 1.0, a - b)
    disc = d1 * d1 - da * db
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    sq = jnp.where(b >= a, sq, -sq)
    denom = db - da + 2.0 * sq
    t = b - (b - a) * (db + sq - d1) / jnp.where(denom == 0, 1.0, denom)
    width = hi - lo
    t_ok = (
        jnp.isfinite(t)
        & (disc >= 0)
        & (denom != 0)
        & (t > lo + 0.1 * width)
        & (t < hi - 0.1 * width)
    )
    return jnp.where(t_ok, t, 0.5 * (lo + hi))


def _wolfe_linesearch(fun, x, f0, g0, direction, dg0, step0, ftol, wolfe,
                      max_linesearch):
    """Strong-Wolfe bracket+zoom line search (Nocedal-Wright alg. 3.5/3.6,
    the conditions MoreThuente enforces), as one ``lax.while_loop``.

    Returns ``(xnew, fnew, gnew, accepted, rounding)``:
      accepted  — a point with sufficient decrease was taken (with curvature
                  when reachable within the evaluation budget; decrease-only
                  as fallback, which is strictly better than terminating),
      rounding  — no decrease is resolvable at this float precision; treat
                  as completed (reference: LBFGSERR_ROUNDING_ERROR -> done).
    """
    dtype = f0.dtype
    eps_f = jnp.array(
        10.0 * jnp.finfo(jnp.float32).eps, dtype
    )  # f32 resolution guard — params/loss are float32 as in the reference

    def suff(alpha, fa):
        return fa <= f0 + ftol * alpha * dg0

    def curv(dga):
        return jnp.abs(dga) <= wolfe * jnp.abs(dg0)

    # carry: (stage, alpha, lo, f_lo, dg_lo, hi, f_hi, dg_hi,
    #         best_alpha, best_f, x_out, f_out, g_out,
    #         accepted, trials, min_fgap)
    # stage 0 = bracketing, 1 = zoom.  (lo, hi) only meaningful in zoom.
    zero = jnp.array(0.0, dtype)

    def cond(c):
        (stage, alpha, lo, f_lo, dg_lo, hi, f_hi, dg_hi, best_a, best_f,
         x_out, f_out, g_out, accepted, trials, min_fgap) = c
        # stop when accepted, budget exhausted, or zoom interval collapsed
        width_ok = jnp.where(
            stage == 1,
            jnp.abs(hi - lo) > 1e-10 * jnp.maximum(jnp.abs(hi), 1.0),
            True,
        )
        return (~accepted) & (trials < max_linesearch) & width_ok & (alpha > 0)

    def body(c):
        (stage, alpha, lo, f_lo, dg_lo, hi, f_hi, dg_hi, best_a, best_f,
         x_out, f_out, g_out, accepted, trials, min_fgap) = c
        xnew = x + alpha * direction
        fnew, gnew = fun(xnew)
        dgnew = jnp.vdot(gnew, direction).astype(dtype)
        trials = trials + 1
        min_fgap = jnp.minimum(min_fgap, fnew - f0)

        ok_suff = suff(alpha, fnew)
        ok_curv = curv(dgnew)
        accept_now = ok_suff & ok_curv

        # track best strict-decrease point as acceptance fallback; the
        # accepted point also routes through the same single select round
        # (full-vector selects are the traffic hot spot of this loop)
        better = (fnew < best_f) | accept_now
        best_a = jnp.where(better, alpha, best_a)
        new_best_f = jnp.where(better, fnew, best_f)
        x_out = jnp.where(better, xnew, x_out)
        f_out = jnp.where(better, fnew, f_out)
        g_out = jnp.where(better, gnew, g_out)

        is_bracket = stage == 0
        # --- bracketing-stage transitions
        br_to_zoom_hi = (~ok_suff) | ((fnew >= f_lo) & (trials > 1))
        br_to_zoom_rev = ok_suff & (~ok_curv) & (dgnew >= 0)
        br_expand = ok_suff & (~ok_curv) & (dgnew < 0)

        # --- zoom-stage updates (alpha is inside [lo, hi])
        zm_shrink_hi = (~ok_suff) | (fnew >= f_lo)
        zm_flip = ok_suff & (fnew < f_lo) & (dgnew * (hi - lo) >= 0)

        n_stage = jnp.where(is_bracket & (br_to_zoom_hi | br_to_zoom_rev),
                            1, stage)

        # new bracket endpoints
        n_lo = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_rev | br_expand, alpha, lo),
            jnp.where(zm_shrink_hi, lo, alpha),
        )
        n_f_lo = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_rev | br_expand, fnew, f_lo),
            jnp.where(zm_shrink_hi, f_lo, fnew),
        )
        n_dg_lo = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_rev | br_expand, dgnew, dg_lo),
            jnp.where(zm_shrink_hi, dg_lo, dgnew),
        )
        n_hi = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_hi, alpha, jnp.where(br_to_zoom_rev, lo, hi)),
            jnp.where(zm_shrink_hi, alpha, jnp.where(zm_flip, lo, hi)),
        )
        n_f_hi = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_hi, fnew, jnp.where(br_to_zoom_rev, f_lo, f_hi)),
            jnp.where(zm_shrink_hi, fnew, jnp.where(zm_flip, f_lo, f_hi)),
        )
        n_dg_hi = jnp.where(
            is_bracket,
            jnp.where(br_to_zoom_hi, dgnew, jnp.where(br_to_zoom_rev, dg_lo, dg_hi)),
            jnp.where(zm_shrink_hi, dgnew, jnp.where(zm_flip, dg_lo, dg_hi)),
        )

        # next trial step
        lo_b = jnp.minimum(n_lo, n_hi)
        hi_b = jnp.maximum(n_lo, n_hi)
        interp = _cubic_step(n_lo, n_f_lo, n_dg_lo, n_hi, n_f_hi, n_dg_hi,
                             lo_b, hi_b)
        n_alpha = jnp.where(
            is_bracket & br_expand,
            jnp.minimum(alpha * 2.1, jnp.array(1e20, dtype)),
            interp,
        )

        return (n_stage, n_alpha, n_lo, n_f_lo, n_dg_lo, n_hi, n_f_hi,
                n_dg_hi, best_a, new_best_f, x_out, f_out, g_out,
                accepted | accept_now, trials, min_fgap)

    init = (
        jnp.array(0, jnp.int32),  # stage
        step0,                     # alpha
        zero, f0, dg0,             # lo, f_lo, dg_lo  (alpha = 0 endpoint)
        zero, f0, dg0,             # hi, f_hi, dg_hi  (unused until zoom)
        zero, f0,                  # best_alpha, best_f
        x, f0, g0,                 # x_out, f_out, g_out
        jnp.array(False),          # accepted
        jnp.array(0, jnp.int32),   # trials
        jnp.array(jnp.inf, dtype), # min (fnew - f0) observed
    )
    (stage, alpha, lo, f_lo, dg_lo, hi, f_hi, dg_hi, best_a, best_f,
     x_out, f_out, g_out, accepted, trials, min_fgap) = jax.lax.while_loop(
        cond, body, init
    )

    decreased = best_f < f0
    took_step = accepted | decreased
    # rounding-limit completion: every trial's decrease was below float32
    # resolution of f0 — mirror of libLBFGS LBFGSERR_ROUNDING_ERROR, which
    # the reference driver reports as "optimization completed"
    rounding = (~took_step) & (min_fgap <= eps_f * jnp.abs(f0))
    return x_out, f_out, g_out, took_step, rounding, trials


def lbfgs_init(
    fun: Callable[[jax.Array], Tuple[jax.Array, jax.Array]],
    x0: jax.Array,
    *,
    m: int = 5,
    epsilon: float = 1e-3,
) -> LBFGSState:
    """Evaluate ``fun`` at ``x0`` and build the initial optimizer state."""
    dtype = x0.dtype
    d = x0.shape[0]
    f0, g0 = fun(x0)
    init = LBFGSState(
        x=x0,
        f=f0,
        g=g0,
        s_hist=jnp.zeros((m, d), dtype),
        y_hist=jnp.zeros((m, d), dtype),
        rho=jnp.zeros(m, dtype),
        k=jnp.array(0, jnp.int32),
        done=jnp.array(False),
        converged=jnp.array(False),
        ls_failed=jnp.array(False),
        n_evals=jnp.array(1, jnp.int32),
    )
    # immediate convergence check (libLBFGS does this before iterating)
    gnorm0 = jnp.linalg.norm(g0)
    xnorm0 = jnp.maximum(jnp.linalg.norm(x0), 1.0)
    return init._replace(
        converged=gnorm0 / xnorm0 <= epsilon, done=gnorm0 / xnorm0 <= epsilon
    )


def lbfgs_steps(
    fun: Callable[[jax.Array], Tuple[jax.Array, jax.Array]],
    state: LBFGSState,
    num_steps: int,
    *,
    epsilon: float = 1e-3,
    ftol: float = 1e-4,
    wolfe: float = 0.9,
    max_linesearch: int = 10,
) -> LBFGSState:
    """Advance the optimizer by up to ``num_steps`` L-BFGS iterations.

    One traced ``lax.while_loop``; call repeatedly from the host to chunk a
    long optimization into short device programs (progress logging,
    checkpointing, robustness to preempted/long-running device calls).
    """
    m = state.s_hist.shape[0]
    dtype = state.x.dtype
    k_start = state.k

    def cond(st: LBFGSState):
        return jnp.logical_and(~st.done, st.k < k_start + num_steps)

    def body(st: LBFGSState):
        direction = _two_loop(st.g, st.s_hist, st.y_hist, st.rho, st.k, m)
        dnorm = jnp.linalg.norm(direction)
        dg0 = jnp.vdot(st.g, direction)
        # fall back to steepest descent if not a descent direction
        bad_dir = dg0 >= 0
        direction = jnp.where(bad_dir, -st.g, direction)
        dg0 = jnp.where(bad_dir, -jnp.vdot(st.g, st.g), dg0)
        dnorm = jnp.where(bad_dir, jnp.linalg.norm(st.g), dnorm)

        step0 = jnp.where(st.k == 0, 1.0 / jnp.maximum(dnorm, 1e-30), 1.0).astype(dtype)

        xnew, fnew, gnew, took_step, rounding, ls_trials = _wolfe_linesearch(
            fun, st.x, st.f, st.g, direction, dg0.astype(dtype), step0,
            jnp.array(ftol, dtype), jnp.array(wolfe, dtype), max_linesearch,
        )

        # Straight-line field-wise merge.  A lax.cond here lowers to a
        # select over the ENTIRE state (both branches materialized) — at
        # D=8.35M that and whole-(m, D) history copies put the machinery
        # far above its traffic roofline.  On failure the line search
        # already returns (xnew, fnew, gnew) == (x, f, g) bitwise, so the
        # big fields need no gating at all; s/y are then zero, sy = 0, and
        # the history update self-gates.  Only scalars carry conditionals.
        s = xnew - st.x
        y = gnew - st.g
        sy = jnp.vdot(s, y)
        slot = jnp.mod(st.k, m)
        do_update = took_step & (sy > 1e-10)
        # row-level history write: select the ROW, then one in-place
        # dynamic update — never copy/select the whole (m, D) buffer
        s_row = jnp.where(
            do_update, s, jax.lax.dynamic_index_in_dim(st.s_hist, slot, 0, False)
        )
        y_row = jnp.where(
            do_update, y, jax.lax.dynamic_index_in_dim(st.y_hist, slot, 0, False)
        )
        s_hist = jax.lax.dynamic_update_index_in_dim(st.s_hist, s_row, slot, 0)
        y_hist = jax.lax.dynamic_update_index_in_dim(st.y_hist, y_row, slot, 0)
        rho_v = jnp.where(
            do_update,
            1.0 / jnp.where(sy == 0, 1.0, sy),
            st.rho[slot],
        ).astype(st.rho.dtype)
        rho = st.rho.at[slot].set(rho_v)

        gnorm = jnp.linalg.norm(gnew)
        xnorm = jnp.maximum(jnp.linalg.norm(xnew), 1.0)
        conv = gnorm / xnorm <= epsilon
        return LBFGSState(
            x=xnew,
            f=fnew,
            g=gnew,
            s_hist=s_hist,
            y_hist=y_hist,
            rho=rho,
            k=jnp.where(took_step, st.k + 1, st.k),
            done=jnp.where(took_step, conv, True),
            converged=jnp.where(took_step, conv, st.converged | rounding),
            ls_failed=jnp.where(took_step, st.ls_failed, ~rounding),
            n_evals=st.n_evals + ls_trials,
        )

    return jax.lax.while_loop(cond, body, state)


def result_from_state(state: LBFGSState) -> LBFGSResult:
    return LBFGSResult(
        x=state.x,
        fx=state.f,
        gnorm=jnp.linalg.norm(state.g),
        num_iters=state.k,
        converged=state.converged,
        linesearch_failed=state.ls_failed,
        n_evals=state.n_evals,
    )


def lbfgs_minimize(
    fun: Callable[[jax.Array], Tuple[jax.Array, jax.Array]],
    x0: jax.Array,
    *,
    m: int = 5,
    max_iterations: int = 100,
    epsilon: float = 1e-3,
    ftol: float = 1e-4,
    wolfe: float = 0.9,
    max_linesearch: int = 10,
) -> LBFGSResult:
    """Minimize ``fun`` (returning ``(value, grad)``) from ``x0``.

    Single-program form: init + one ``lax.while_loop`` over all iterations.
    ``max_iterations`` counts outer L-BFGS iterations as in the reference's
    knob (``plmdca.py:72``).  For host-chunked execution use
    :func:`lbfgs_init` / :func:`lbfgs_steps`.
    """
    state = lbfgs_init(fun, x0, m=m, epsilon=epsilon)
    state = lbfgs_steps(
        fun,
        state,
        max_iterations,
        epsilon=epsilon,
        ftol=ftol,
        wolfe=wolfe,
        max_linesearch=max_linesearch,
    )
    return result_from_state(state)
