"""DCA scoring: Frobenius norm, average product correction, direct information.

The reference duplicates this logic across both engines and two numerics
modules (``pydca/meanfield_dca/meanfield_dca.py:902-988``,
``pydca/plmdca/plmdca.py:437-524``, ``pydca/*/msa_numerics.py``); here it is a
single vectorized layer operating on per-pair coupling blocks of shape
``(P, q-1, q-1)`` in the canonical pair order (0,1), (0,2), ..., (L-2, L-1).

Everything is jittable; the per-pair two-site-model fixed point runs as a
``vmap`` over pairs of a ``lax.while_loop``, replacing the reference's serial
Python loop (``pydca/meanfield_dca/msa_numerics.py:377-442``).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "gauge_shift",
    "frobenius_norms",
    "frobenius_norms_from_matrix",
    "apc",
    "two_site_model_fields",
    "direct_information",
    "sorted_scores",
]

_TWO_SITE_TOL = 1.0e-4
_TWO_SITE_MAX_ITERS = 10_000  # reference iterates unboundedly; we add a safety cap
_DI_EPSILON = 1.0e-20


def gauge_shift(blocks: jax.Array) -> jax.Array:
    """Zero-sum-gauge shift per coupling block: ``J - rowmean - colmean + mean``.

    ``blocks``: (..., q', q').  Reference: ``meanfield_dca.py:636-658``.
    """
    avx = jnp.mean(blocks, axis=-1, keepdims=True)
    avy = jnp.mean(blocks, axis=-2, keepdims=True)
    av = jnp.mean(blocks, axis=(-2, -1), keepdims=True)
    return blocks - avx - avy + av


@jax.jit
@jax.jit
def frobenius_norms(blocks: jax.Array) -> jax.Array:
    """Frobenius norm of gauge-shifted coupling blocks: ``(P,)`` scores.

    Reference: ``meanfield_dca.py:926-940`` / ``plmdca.py:461-477``.
    Jitted: called eagerly from the engines, one cacheable program
    (warmed by ``warmup_plm``) instead of a handful of per-op dispatches.
    """
    shifted = gauge_shift(blocks)
    return jnp.sqrt(jnp.sum(shifted * shifted, axis=(-2, -1)))


@functools.partial(jax.jit, static_argnames=("l", "qm1"))
def _fn_matrix_sq(couplings: jax.Array, l: int, qm1: int) -> jax.Array:
    """Squared gauge-shifted Frobenius norm of every (i, j) block, ``(L, L)``.

    Uses the orthogonal (two-way ANOVA) decomposition of the zero-sum-gauge
    shift: for an n x n block M with row sums r, column sums c, total t,

        ||M - rowmean - colmean + mean||_F^2
            = sum M^2 - (sum_a r_a^2)/n - (sum_b c_b^2)/n + t^2/n^2

    so the per-pair norms reduce directly over the full coupling matrix with
    no (L, L, q', q') transpose copy and no pair gather — at L=1000 protein
    that avoids ~3 GB of materialized intermediates.
    """
    j4 = couplings.reshape(l, qm1, l, qm1)
    n = qm1
    sq = jnp.sum(j4 * j4, axis=(1, 3))  # (L, L)
    rs = jnp.sum(j4, axis=3)  # (L, n, L): row sums of block (i, j)
    cs = jnp.sum(j4, axis=1)  # (L, L, n): column sums
    tot = jnp.sum(rs, axis=1)  # (L, L)
    # The final subtraction is cancellation-prone for weak pairs (the four
    # terms are large and nearly equal); combine the (L, L)-reduced terms in
    # float64 — cheap (O(L^2) elements), and exact inner accumulations are
    # not the issue.  x64 may be disabled (the JAX default): jnp falls back to
    # f32 there, which matches the previous behavior.
    acc = jnp.float64 if jax.config.jax_enable_x64 else couplings.dtype
    out = (
        sq.astype(acc)
        - jnp.sum(rs * rs, axis=1).astype(acc) / n
        - jnp.sum(cs * cs, axis=2).astype(acc) / n
        + (tot * tot).astype(acc) / (n * n)
    )
    return out.astype(couplings.dtype)


def frobenius_norms_from_matrix(couplings: jax.Array, l: int, qm1: int) -> jax.Array:
    """FN scores ``(P,)`` in pair order from a full (L*q', L*q') coupling matrix.

    Equivalent to ``frobenius_norms`` over the extracted per-pair blocks
    (reference ``meanfield_dca.py:926-940``) but computed with block
    reductions over the matrix itself.
    """
    fn2 = _fn_matrix_sq(couplings, l, qm1)
    iu, ju = np.triu_indices(l, k=1)
    return jnp.sqrt(jnp.maximum(fn2[iu, ju], 0.0))


@functools.partial(jax.jit, static_argnames=("l",))
def apc(scores: jax.Array, l: int) -> jax.Array:
    """Average product correction over per-pair scores ``(P,)`` -> ``(P,)``.

    ``APC(i,j) = s(i,j) - av_i * av_j / av_all`` where ``av_i`` is the mean
    score of pairs containing site ``i`` (over L-1 pairs) and ``av_all`` the
    mean of the ``av_i``.  Reference: ``meanfield_dca.py:968-983``.
    """
    iu, ju = np.triu_indices(l, k=1)
    # per-site mean over the L-1 pairs containing the site
    site_sums = jnp.zeros(l, scores.dtype).at[iu].add(scores).at[ju].add(scores)
    av_sites = site_sums / (l - 1)
    av_all = jnp.mean(av_sites)
    return scores - av_sites[iu] * av_sites[ju] / av_all


def _embed_blocks_with_gap(blocks: jax.Array, q: int) -> jax.Array:
    """Embed (P, q-1, q-1) coupling blocks into (P, q, q) with zero gap row/col.

    Mirrors ``slice_couplings`` (``meanfield_dca/msa_numerics.py:346-374``):
    gap couplings are zero, so ``exp`` of the embedded block is 1 there.
    """
    p = blocks.shape[0]
    out = jnp.zeros((p, q, q), blocks.dtype)
    return out.at[:, : q - 1, : q - 1].set(blocks)


@functools.partial(jax.jit, static_argnames=("l", "q"))
def two_site_model_fields(
    blocks: jax.Array, fi_reg: jax.Array, l: int, q: int
) -> Tuple[jax.Array, jax.Array]:
    """Per-pair two-site-model fields via fixed-point iteration.

    For every pair (i, j) solves for fields ``(hi, hj)`` such that the two-site
    model ``p(a,b) ~ exp(Jij(a,b)) hi(a) hj(b)`` reproduces the regularized
    marginals ``fi`` and ``fj``.  Tolerance 1e-4 on the max field change,
    mirroring ``pydca/meanfield_dca/msa_numerics.py:377-442`` (which has no
    iteration cap; we bound at 10^4 for compiled control flow).

    Returns ``(hi, hj)`` each of shape ``(P, q)``.
    """
    w = jnp.exp(_embed_blocks_with_gap(blocks, q))  # (P, q, q)
    iu, ju = np.triu_indices(l, k=1)
    freq_i = fi_reg[iu]  # (P, q)
    freq_j = fi_reg[ju]

    def solve_pair(wij, fi, fj):
        def cond(state):
            hi, hj, delta, it = state
            return jnp.logical_and(delta > _TWO_SITE_TOL, it < _TWO_SITE_MAX_ITERS)

        def body(state):
            hi, hj, _, it = state
            xi = wij @ hj
            xj = wij.T @ hi
            hi_new = fi / xi
            hi_new = hi_new / jnp.sum(hi_new)
            hj_new = fj / xj
            hj_new = hj_new / jnp.sum(hj_new)
            delta = jnp.maximum(
                jnp.max(jnp.abs(hi_new - hi)), jnp.max(jnp.abs(hj_new - hj))
            )
            return hi_new, hj_new, delta, it + 1

        init = (
            jnp.full((q,), 1.0 / q, blocks.dtype),
            jnp.full((q,), 1.0 / q, blocks.dtype),
            jnp.array(10.0, blocks.dtype),
            jnp.array(0, jnp.int32),
        )
        hi, hj, _, _ = jax.lax.while_loop(cond, body, init)
        return hi, hj

    return jax.vmap(solve_pair)(w, freq_i, freq_j)


@functools.partial(jax.jit, static_argnames=("l", "q"))
def direct_information(
    blocks: jax.Array, fi_reg: jax.Array, l: int, q: int
) -> jax.Array:
    """Direct information per pair, ``(P,)``.

    ``DI = sum_{a,b in residues} pdir(a,b) log(pdir(a,b) / (fi(a) fj(b)))``
    where ``pdir ~ exp(Jij) hi hj`` is normalized over all q x q states but the
    sum runs over the (q-1)^2 residue states only, with epsilon 1e-20
    (reference: ``pydca/meanfield_dca/msa_numerics.py:445-533``).
    """
    hi, hj = two_site_model_fields(blocks, fi_reg, l, q)
    w = jnp.exp(_embed_blocks_with_gap(blocks, q))
    pdir = w * hi[:, :, None] * hj[:, None, :]
    pdir = pdir / jnp.sum(pdir, axis=(-2, -1), keepdims=True)
    iu, ju = np.triu_indices(l, k=1)
    fprod = fi_reg[iu][:, :, None] * fi_reg[ju][:, None, :]
    pr = pdir[:, : q - 1, : q - 1] + _DI_EPSILON
    fr = fprod[:, : q - 1, : q - 1] + _DI_EPSILON
    return jnp.sum(pr * jnp.log(pr / fr), axis=(-2, -1))


def sorted_scores(scores: np.ndarray, l: int) -> List[Tuple[Tuple[int, int], float]]:
    """Convert per-pair scores ``(P,)`` into the reference's sorted list form
    ``[((i, j), score), ...]`` in descending score order (0-based sites).
    """
    scores = np.asarray(scores)
    iu, ju = np.triu_indices(l, k=1)
    order = np.argsort(-scores, kind="stable")
    return [
        ((int(iu[k]), int(ju[k])), float(scores[k])) for k in order
    ]
