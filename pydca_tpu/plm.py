"""Pseudolikelihood-maximization DCA (plmDCA) on JAX.

Replaces the reference's C++/OpenMP backend (``pydca/plmdca/plmdca_numerics.cpp``
+ vendored float32 libLBFGS) with a JAX formulation built on matmuls:

- The per-site conditional logits for *all* sites and sequences at once are a
  single matmul ``logits = X @ Jmat.T + h`` with ``X`` the one-hot alignment
  ``(N, L*q)`` and ``Jmat`` the symmetric coupling matrix ``(L*q, L*q)``
  (the reference's hot loop ``plmdca_numerics.cpp:436-607`` is O(N L^2 q)
  scalar work per L-BFGS iteration; here it is 2·N·(Lq)^2 matmul FLOPs).
- Parameters live in a flat float32 vector in the *reference's exact layout*
  (fields site-major then couplings pair-major; ``plmdca_numerics.cpp:319-365``)
  so parameter-level comparisons against the reference backend are direct.
  The symmetric-J variant (one J_ij per pair feeding both conditionals i and j)
  falls out of AD through the triu gather that expands the flat couplings to
  the full (L, L, q, q) tensor.
- The optimizer is the jittable L-BFGS in :mod:`pydca_tpu.ops.lbfgs` with the
  reference's budget (m=5, eps=1e-3, ftol=1e-4, <=100 iterations;
  ``plmdcaBackend.cpp:68-75``; line-search cap 10 vs the reference's 5 —
  a documented deviation, see ``ops/lbfgs.py``).

Note: the reference gradient carries its softmax accumulator across sequences
without resetting (``plmdca_numerics.cpp:492-499``), slightly perturbing its
objective; this implementation computes the exact pseudolikelihood, so
score parity with the reference is at ranking level, not parameter level.

The loss is exposed in both a full-batch form and a sequence-sharded form
(see :mod:`pydca_tpu.parallel`): the only cross-sequence coupling is a sum, so
gradients merge with a psum over the data mesh axis.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import score as score_mod
from . import stats
from .io.fasta import MSA, read_msa
from .ops.lbfgs import (
    LBFGSResult,
    direction_coeffs,
    lbfgs_init,
    lbfgs_steps,
    result_from_state,
    wolfe_scalar,
)
from . import runtime
from .profiling import StageTimers

logger = logging.getLogger(__name__)

__all__ = ["PlmDCA", "PlmDCAException", "plm_loss_and_grad", "fit_plm"]


class PlmDCAException(Exception):
    """Errors specific to the plmDCA engine."""


def default_mm_bf16() -> bool:
    """Default matmul precision flag: keep float32 *operands* (no explicit
    bf16 casts).

    Note what the hardware then does: under JAX's DEFAULT matmul precision
    a GPU runs f32-operand matmuls as TF32 on the tensor cores (float32
    accumulation), so the default path is not true-f32 compute either.
    bf16 operands are an explicit knob (``precision="bfloat16"``); ranking
    parity under it is CI-tested.  Whether bf16 pays on the GPU is not
    measured yet."""
    return False


def resolve_precision(precision) -> bool:
    """Map a user-facing precision name to the ``mm_bf16`` flag.

    ``None``/"auto" -> backend default; "bfloat16"/"bf16" -> True;
    "float32"/"f32" -> False.
    """
    if precision is None or precision == "auto":
        return default_mm_bf16()
    if precision in ("bfloat16", "bf16"):
        return True
    if precision in ("float32", "f32"):
        return False
    raise PlmDCAException(
        f"invalid precision {precision!r}; choose auto, bfloat16 or float32"
    )


def default_hist_bf16() -> bool:
    """Default dtype of the fused loop's L-BFGS history rows.

    The history reads (the direction combination and the Z @ g' refresh,
    2 x 2m x D per iteration) are pure device-memory traffic; storing the
    rows in bfloat16 halves it.  The rows only feed the quasi-Newton
    direction (a preconditioner), so the 0.4% rounding perturbs the
    trajectory, not correctness — the line search guards every step.
    The GPU default follows the PF02826-shape fit measured on an H100
    (PERF.md); CPU keeps float32 (bf16 is emulated there).
    """
    return runtime.backend() == "gpu"


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _logits_mm(x: jax.Array, w4: jax.Array, mm_bf16: bool) -> jax.Array:
    """Logits matmul on 4-D operands: ``x3 (n, j, b)`` x ``w4 (j, b, a, i)``
    -> ``(n, a, i)``, with optional bfloat16 operands and f32 accumulation.

    The operands stay 4-D on purpose: the algebraically equivalent 2-D
    form needs ``w4.reshape(Lq, qL)`` of a TRANSPOSED tensor, and that
    reshape is an XLA compile pathology — 30-95 s at PF02826 shape vs
    ~2 s for the same contraction expressed with two contracting dims
    (r5 cold-compile bisection; the emitted kernel is identical).

    Custom VJP: with bf16 operands the backward pass casts the *cotangent*
    to bfloat16 too, so the gradient matmul also runs at the tensor cores'
    bf16 rate (JAX's default transpose would mix a bf16 operand with the
    f32 cotangent and fall back to f32 throughput). ``x`` is the constant
    one-hot alignment — its returned cotangent is a symbolic zero that XLA
    dead-code-eliminates.
    """
    mm_dtype = jnp.bfloat16 if mm_bf16 else x.dtype
    acc_dtype = jnp.float32 if mm_bf16 else x.dtype
    return jax.lax.dot_general(
        x.astype(mm_dtype),
        w4.astype(mm_dtype),
        dimension_numbers=(((1, 2), (0, 1)), ((), ())),
        preferred_element_type=acc_dtype,
    )


def _logits_mm_fwd(x, w4, mm_bf16: bool):
    # zero-size dtype token: residuals must be JAX types, not dtypes
    return _logits_mm(x, w4, mm_bf16), (x, jnp.zeros((0,), w4.dtype))


def _logits_mm_bwd(mm_bf16: bool, res, ct):
    x, w4_token = res
    mm_dtype = jnp.bfloat16 if mm_bf16 else x.dtype
    acc_dtype = jnp.float32 if mm_bf16 else x.dtype
    # ct is (n, a, i); contracting n gives the (j, b, a, i) cotangent
    dw4 = jax.lax.dot_general(
        x.astype(mm_dtype),
        ct.astype(mm_dtype),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=acc_dtype,
    ).astype(w4_token.dtype)
    return jnp.zeros_like(x), dw4


_logits_mm.defvjp(_logits_mm_fwd, _logits_mm_bwd)


# --------------------------------------------------------------- loss function
@functools.lru_cache(maxsize=None)
def _triu_pairs(l: int):
    iu, ju = np.triu_indices(l, k=1)
    return iu, ju


def _pair_pullback_rows(cr: jax.Array, l: int, q: int) -> jax.Array:
    """Shared pullback tail: (l*l, q*q) rows in (i, j)-major order with
    (a, b)-contiguous content -> flat (P*q*q,) pair-gradient.

    Each pair (i < j) receives its own (i, j) block plus the transposed
    (j, i) block.  Both gathers are whole-row 2-D gathers — gathering
    (q, q) blocks through a fused transpose vectorizes worse (see the
    layout note at :func:`_expand_full`).  Single source of truth for the
    expansion VJP, the fused loop's pullback and the streaming scan tail.
    """
    iu, ju = _triu_pairs(l)
    d_ij = cr[jnp.asarray(iu * l + ju)].reshape(-1, q, q)
    d_ji = cr[jnp.asarray(ju * l + iu)].reshape(-1, q, q)
    return (d_ij + jnp.swapaxes(d_ji, -1, -2)).reshape(-1)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def _expand_full(j_flat: jax.Array, l: int, q: int) -> jax.Array:
    """Expand flat (P, q, q) couplings to the full symmetric (L, L, q, q) tensor.

    ``J_full[i, j] = J_pair(i,j)`` for i < j, its transpose for i > j, zeros on
    the diagonal — exactly the symmetric-variant storage the reference uses
    (``plmdca_numerics.cpp:501-517``: site i's conditional reads J_ji[s_j, a]
    for j < i and J_ij[a, s_j] for j > i).

    Custom VJP: the autodiff backward of the pair-index gather is a
    scatter-add; the hand-written backward gathers the (i, j) and
    transposed (j, i) cotangent blocks instead (pure gathers, no scatter).

    Layout note: the gather runs on a 2-D ``(P, q*q)`` view — XLA vectorizes
    whole-row gathers better than gathers of ``(P, q, q)`` blocks by the
    same index.
    """
    jg = j_flat.reshape(-1, q * q)[
        jnp.asarray(stats.pair_index_matrix(l).reshape(-1))
    ].reshape(l, l, q, q)
    ii = jnp.arange(l)[:, None]
    jj = jnp.arange(l)[None, :]
    lower = (ii > jj)[:, :, None, None]
    diag = (ii == jj)[:, :, None, None]
    jfull = jnp.where(lower, jnp.swapaxes(jg, -1, -2), jg)
    return jnp.where(diag, jnp.zeros_like(jfull), jfull)


def _expand_full_fwd(j_flat, l: int, q: int):
    return _expand_full(j_flat, l, q), None


def _expand_full_bwd(l: int, q: int, _, ct):
    return (_pair_pullback_rows(ct.reshape(l * l, q * q), l, q),)


_expand_full.defvjp(_expand_full_fwd, _expand_full_bwd)


def _expand_couplings(j_flat: jax.Array, pidx: jax.Array, l: int, q: int) -> jax.Array:
    """Back-compat wrapper: ``pidx`` must equal ``stats.pair_index_matrix(l)``
    (it always is); the expansion itself derives the index map statically."""
    del pidx
    return _expand_full(j_flat, l, q)


@functools.partial(jax.jit, static_argnames=("l", "q", "mm_bf16"))
def plm_loss(
    theta: jax.Array,
    msa: jax.Array,
    weights: jax.Array,
    pidx: jax.Array,
    lambda_h: jax.Array,
    lambda_j: jax.Array,
    l: int,
    q: int,
    mm_bf16: bool = False,
) -> jax.Array:
    """Regularized negative log-pseudolikelihood (symmetric-J variant).

    ``loss = sum_i sum_n -w_n log P(s_ni | s_n,-i) + lambda_h ||h||^2
    + lambda_J ||J_triu||^2``  (``plmdca_numerics.cpp:436-607``).
    """
    x, maskq = _prep_msa(msa, l, q, theta.dtype)
    return _plm_loss_prepped(
        theta, x, maskq, weights, lambda_h, lambda_j, l, q, mm_bf16
    )


def _prep_msa(msa: jax.Array, l: int, q: int, dtype):
    """One-hot ``(N, Lq)`` and per-state pick mask ``(N, q, L)`` for the loss.

    Factored out so the optimizer can compute these once per device program
    (outside the L-BFGS ``while_loop``) instead of once per objective
    evaluation.
    """
    x = jax.nn.one_hot(msa, q, dtype=dtype)  # (N, L, q): stays 3-D —
    # the logits contraction pairs (j, b) as two dims (see _logits_mm)
    maskq = msa[:, None, :] == jnp.arange(q, dtype=msa.dtype)[None, :, None]
    return x, maskq


def _plm_loss_prepped(
    theta, x, maskq, weights, lambda_h, lambda_j, l: int, q: int,
    mm_bf16: bool = False,
):
    """Loss on pre-encoded inputs, with logits in ``(N, q, L)`` layout.

    Layout note: arranging the coupling matrix columns (a-major, i-minor)
    makes the matmul emit logits as ``(N, q, L)``, so the softmax/pick
    reductions run over a middle axis with the long L axis contiguous,
    instead of over a trailing axis of only q (5 or 21) elements.
    """
    dtype = theta.dtype
    h = theta[: l * q].reshape(l, q)
    # (j, b) leading = contraction side; (a, i) trailing = output side
    w4 = _expand_full(theta[l * q :], l, q).transpose(1, 3, 2, 0)
    logits = _logits_mm(x, w4, mm_bf16) + h.T[None]
    lse = _lse_q(logits)  # (N, L)
    picked = jnp.sum(jnp.where(maskq, logits, 0), axis=1)  # (N, L)
    nll = jnp.sum(weights[:, None] * (lse - picked))
    reg = lambda_h * jnp.sum(h * h) + lambda_j * jnp.sum(theta[l * q :] ** 2)
    return nll + reg


def _lse_q(logits: jax.Array) -> jax.Array:
    """Stable logsumexp over the middle (q) axis of ``(N, q, L)`` logits.

    Hand-rolled: the logits are always finite here, so scipy's inf/nan
    guard passes (`where`/`isfinite` over the full tensor) are dead weight
    on an HBM-bandwidth-bound epilogue.
    """
    mx = jax.lax.stop_gradient(jnp.max(logits, axis=1))
    return mx + jnp.log(jnp.sum(jnp.exp(logits - mx[:, None, :]), axis=1))


def plm_loss_and_grad(
    theta, msa, weights, pidx, lambda_h, lambda_j, l, q, mm_bf16=False
):
    return jax.value_and_grad(plm_loss)(
        theta, msa, weights, pidx, lambda_h, lambda_j, l, q, mm_bf16
    )


# ------------------------------------------------- w2-space ("z-space") loss
#
# In the compact-theta step the coupling expansion (theta_J -> w2) and its
# VJP can cost more than the two logits matmuls.  Optimizing directly over
# the FULL symmetric coupling matrix w2 (the matmul operand itself)
# deletes the expansion entirely.  L-BFGS then runs on z = [h, w2] restricted
# to the linear subspace S = {w2 symmetric-under-pair-mirror, zero
# diagonal blocks}: the iterates stay in S because z0 is in S and every
# gradient is projected onto S, so the optimization is plain L-BFGS of
# the same strictly convex objective on S (same unique optimum as the
# compact parameterization; the trajectory differs — a different inner
# -product geometry — which is fine at the score-ranking parity bar).
# Memory: z is (Lq)^2 + Lq floats and the L-BFGS history holds 2m+2 such
# vectors, so this path is gated to problems where that fits comfortably
# (see fit_plm); big-L problems keep the compact path.
#
# The projection P(G) = 0.5 (G + mirror(G)) with diagonal blocks zeroed,
# where mirror[(j,b),(a,i)] = G[(i,a),(b,j)].  Instead of an XLA
# permutation transpose (a full reversal of a D-sized buffer), the custom
# VJP below forms it as a SECOND backward matmul ct_B^T @ x_A — both operands
# already exist: x_A is the (a,i)-ordered one-hot (= maskq) and ct_B is
# the logits cotangent with its (q, l) axes swapped.


def _combine_w2_projection(g_raw, mirror, l: int, q: int):
    """0.5 (G + mirror(G)) with diagonal site blocks zeroed.

    The shared tail of the subspace projection P(G): both w2 gradient
    paths route through it — the full-batch custom VJP (which computes
    ``mirror`` as a second matmul) and the streaming path (which computes
    it as a permutation once per evaluation).  The two paths are pinned
    against each other by ``test_w2_chunked_matches_w2_full``.
    """
    g4 = (0.5 * (g_raw + mirror)).reshape(l, q, q, l)
    offdiag = 1.0 - jnp.eye(l, dtype=g_raw.dtype)
    return (g4 * offdiag[:, None, None, :]).reshape(l * q, q * l)


_LOGITS_MM_SYM_CACHE: Dict[Tuple[int, int], object] = {}


def _make_logits_mm_sym(l: int, q: int):
    """(l, q)-specialized symmetric-projection matmul (cached)."""
    key = (l, q)
    if key in _LOGITS_MM_SYM_CACHE:
        return _LOGITS_MM_SYM_CACHE[key]

    @jax.custom_vjp
    def mm(x, xa, w2):
        return jax.lax.dot_general(
            x, w2, dimension_numbers=(((1,), (0,)), ((), ()))
        )

    def fwd(x, xa, w2):
        return mm(x, xa, w2), (x, xa)

    def bwd(res, ct):
        x, xa = res
        g_raw = jax.lax.dot_general(
            x, ct, dimension_numbers=(((0,), (0,)), ((), ()))
        )  # rows (j,b), cols (a,i)
        ct_b = (
            ct.reshape(-1, q, l).transpose(0, 2, 1).reshape(-1, l * q)
        )  # columns (site, state) = (j, b) index order
        mirror = jax.lax.dot_general(
            ct_b, xa, dimension_numbers=(((0,), (0,)), ((), ()))
        )  # rows (j,b), cols (a,i)
        gsym = _combine_w2_projection(g_raw, mirror, l, q)
        return jnp.zeros_like(x), jnp.zeros_like(xa), gsym

    mm.defvjp(fwd, bwd)
    _LOGITS_MM_SYM_CACHE[key] = mm
    return mm


def theta_to_z(theta: jax.Array, l: int, q: int) -> jax.Array:
    """Compact reference-layout theta -> z = [h, w2.ravel()] (one-time)."""
    h = theta[: l * q]
    w2 = (
        _expand_full(theta[l * q :], l, q)
        .transpose(1, 3, 2, 0)
        .reshape(-1)
    )
    return jnp.concatenate([h, w2])


def z_to_theta(z: jax.Array, l: int, q: int) -> jax.Array:
    """z = [h, w2.ravel()] -> compact reference-layout theta (one-time).

    Reads the (i < j) blocks (symmetrizing against float drift):
    ``J_p(a, b) = 0.5 * (w4[j, b, a, i] + w4[i, a, b, j])``.
    """
    h = z[: l * q]
    w4 = z[l * q :].reshape(l, q, q, l)
    iu, ju = _triu_pairs(l)
    blk = w4.transpose(3, 0, 2, 1)  # (i, j, a, b)
    j_pairs = 0.5 * (blk[iu, ju] + jnp.swapaxes(blk[ju, iu], -1, -2))
    return jnp.concatenate([h, j_pairs.reshape(-1)])


def _plm_loss_w2_prepped(
    z, x, xa, maskq, weights, lambda_h, lambda_j, l: int, q: int
):
    """Loss over z = [h, w2]; gradient arrives projected onto S.

    The L2 regularizer reads ``0.5 * lambda_J * sum(w2^2)``: every pair
    coupling appears twice in w2, so this equals the compact layout's
    ``lambda_J * sum(J_triu^2)`` exactly (diagonal blocks are zero).
    """
    h = z[: l * q].reshape(l, q)
    w2 = z[l * q :].reshape(l * q, q * l)
    mm = _make_logits_mm_sym(l, q)
    logits = mm(x, xa, w2).reshape(-1, q, l) + h.T[None]
    lse = _lse_q(logits)
    picked = jnp.sum(jnp.where(maskq, logits, 0), axis=1)
    nll = jnp.sum(weights[:, None] * (lse - picked))
    reg = lambda_h * jnp.sum(h * h) + 0.5 * lambda_j * jnp.sum(w2 * w2)
    return nll + reg


# ------------------------------------------------- sequence-chunked (large N)
def _pad_to_blocks_sharded(msa: jax.Array, weights: jax.Array, block: int,
                           l: int, mesh):
    """Device-side streaming prep: (N, L) -> (nb, block, L) blocks placed
    ``P(None, 'data', None)`` WITHOUT materializing the alignment on the
    host.

    Required for multi-host streaming: the global array from
    :mod:`pydca_tpu.parallel.data` holds only each host's stripe;
    ``np.asarray`` would gather all N rows onto every host (defeating
    host-local loading, and raising on non-addressable shards).  GSPMD
    compiles the pad+reshape+reshard into device collectives.  On one
    host it also skips the host->device round trip of the run's biggest
    tensor (r4 ADVICE item 3).
    """
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    n = msa.shape[0]
    nb = -(-n // block)
    pad = nb * block - n

    f = jax.jit(
        lambda m, w: (
            jnp.pad(m, ((0, pad), (0, 0))).reshape(nb, block, l),
            jnp.pad(w, (0, pad)).reshape(nb, block),
        ),
        out_shardings=(
            NamedSharding(mesh, P(None, "data", None)),
            NamedSharding(mesh, P(None, "data")),
        ),
    )
    return f(msa, weights)


def _pad_to_blocks(msa: np.ndarray, weights, block: int):
    """Split (N, L) into (nb, block, L) with zero-weight padding rows."""
    n, l = msa.shape
    nb = -(-n // block)
    pad = nb * block - n
    msa_p = np.concatenate([np.asarray(msa), np.zeros((pad, l), msa.dtype)], 0)
    w_p = jnp.concatenate(
        [jnp.asarray(weights), jnp.zeros((pad,), jnp.asarray(weights).dtype)], 0
    )
    return (
        jnp.asarray(msa_p).reshape(nb, block, l),
        w_p.reshape(nb, block),
    )


@functools.partial(jax.jit, static_argnames=("l", "q", "mm_bf16"))
def plm_loss_and_grad_chunked(
    theta, msa_blocks, w_blocks, pidx, lambda_h, lambda_j, l, q, mm_bf16=False
):
    """Streaming value+grad: ``lax.scan`` over sequence blocks.

    The pseudolikelihood is a plain sum over sequences, so the data term's
    value and gradient accumulate exactly across blocks; only one block's
    one-hot/logits/AD intermediates are live at a time, bounding device
    memory at O(block * L * q) instead of O(N * L * q).  This is the
    single-chip form of the data-parallel decomposition (multi-chip shards
    the same sum over the 'data' mesh axis and psums).
    """
    dtype = theta.dtype
    h = theta[: l * q].reshape(l, q)
    w4 = _expand_full(theta[l * q :], l, q).transpose(1, 3, 2, 0)

    def data_term(params, msa_b, w_b):
        h_b, w4_b = params
        x, maskq = _prep_msa(msa_b, l, q, dtype)
        logits = _logits_mm(x, w4_b, mm_bf16) + h_b.T[None]
        lse = _lse_q(logits)
        picked = jnp.sum(jnp.where(maskq, logits, 0), axis=1)
        return jnp.sum(w_b[:, None] * (lse - picked))

    def body(carry, blk):
        acc_f, acc_gh, acc_gj = carry
        msa_b, w_b = blk
        f_b, (gh_b, gj_b) = jax.value_and_grad(data_term)((h, w4), msa_b, w_b)
        return (acc_f + f_b, acc_gh + gh_b, acc_gj + gj_b), None

    init = (
        jnp.zeros((), dtype),
        jnp.zeros_like(h),
        jnp.zeros_like(w4),
    )
    (nll, gh, gw4), _ = jax.lax.scan(body, init, (msa_blocks, w_blocks))

    # pull the w4 cotangent back through the expansion: gw4 axes are
    # (j, b, a, i) -> reorder to (i, j, a, b) rows for the shared tail
    gj_flat = _pair_pullback_rows(
        gw4.transpose(3, 0, 2, 1).reshape(l * l, q * q), l, q
    )

    jflat = theta[l * q :]
    loss = nll + lambda_h * jnp.sum(h * h) + lambda_j * jnp.sum(jflat**2)
    grad = jnp.concatenate(
        [
            (gh + 2.0 * lambda_h * h).reshape(-1),
            (gj_flat + 2.0 * lambda_j * jflat),
        ]
    )
    return loss, grad


@functools.partial(jax.jit, static_argnames=("l", "q"))
def init_params(msa: jax.Array, weights: jax.Array, l: int, q: int) -> jax.Array:
    """Reference initialization: ``h_ia = log(weighted_count_ia + 1)`` centered
    per site, couplings zero (``plmdca_numerics.cpp:207-249``)."""
    fi = stats.single_site_freqs(msa, weights, q)  # (L, q)
    meff = jnp.sum(weights)
    h = jnp.log(fi * meff + 1.0)
    h = h - jnp.mean(h, axis=1, keepdims=True)
    p = l * (l - 1) // 2
    return jnp.concatenate(
        [h.reshape(-1), jnp.zeros(p * q * q, h.dtype)]
    ).astype(jnp.float32)


@functools.partial(
    jax.jit,
    static_argnames=("l", "q", "num_steps", "chunked", "mm_bf16", "w2space"),
)
def _plm_lbfgs_steps(
    state, msa, weights, pidx, lambda_h, lambda_j, l: int, q: int, num_steps: int,
    chunked: bool = False, mm_bf16: bool = False, w2space: bool = False,
):
    fun = _make_loss_fun(
        msa, weights, pidx, lambda_h, lambda_j, l, q, chunked, mm_bf16, w2space
    )
    return lbfgs_steps(fun, state, num_steps)


@functools.partial(
    jax.jit, static_argnames=("l", "q", "m", "chunked", "mm_bf16", "w2space")
)
def _plm_lbfgs_state0(
    msa, weights, pidx, lambda_h, lambda_j, l: int, q: int, m: int,
    chunked: bool = False, mm_bf16: bool = False, w2space: bool = False,
):
    flat_msa = msa.reshape(-1, l) if chunked else msa
    flat_w = weights.reshape(-1) if chunked else weights
    theta0 = init_params(flat_msa, flat_w, l, q)
    if w2space:
        # J init is zero, so z0 = [h0, 0]: no expansion needed
        theta0 = jnp.concatenate(
            [theta0[: l * q], jnp.zeros((l * q) * (q * l), theta0.dtype)]
        )
    fun = _make_loss_fun(
        msa, weights, pidx, lambda_h, lambda_j, l, q, chunked, mm_bf16, w2space
    )
    return lbfgs_init(fun, theta0, m=m)


def _make_loss_fun(
    msa, weights, pidx, lambda_h, lambda_j, l, q, chunked, mm_bf16,
    w2space=False,
):
    if chunked:
        if w2space:
            return lambda z: plm_loss_and_grad_w2_chunked(
                z, msa, weights, lambda_h, lambda_j, l, q
            )
        return lambda t: plm_loss_and_grad_chunked(
            t, msa, weights, pidx, lambda_h, lambda_j, l, q, mm_bf16
        )
    # Encode once per device program: the one-hot MSA and pick mask are
    # loop-invariant across all objective evaluations of an L-BFGS chunk.
    x, maskq = _prep_msa(msa, l, q, jnp.float32)
    if w2space:
        x2 = x.reshape(-1, l * q)  # untransposed one-hot: trivial reshape
        xa = maskq.astype(jnp.float32).reshape(-1, q * l)
        grad_fn_z = jax.value_and_grad(_plm_loss_w2_prepped)
        return lambda z: grad_fn_z(
            z, x2, xa, maskq, weights, lambda_h, lambda_j, l, q
        )
    grad_fn = jax.value_and_grad(_plm_loss_prepped)
    return lambda t: grad_fn(
        t, x, maskq, weights, lambda_h, lambda_j, l, q, mm_bf16
    )


@functools.partial(jax.jit, static_argnames=("l", "q"))
def plm_loss_and_grad_w2_chunked(
    z, msa_blocks, w_blocks, lambda_h, lambda_j, l, q
):
    """Streaming value+grad over z = [h, w2] (w2-space; see module notes).

    Like :func:`plm_loss_and_grad_chunked` but WITHOUT the per-eval
    coupling expansion and final triu pullback: the scan accumulates the
    raw w2 cotangent and one projection onto the symmetric subspace runs
    after the scan (its one-off cost is negligible against the streamed
    blocks).
    """
    dtype = z.dtype
    h = z[: l * q].reshape(l, q)
    w2 = z[l * q :].reshape(l * q, q * l)

    def data_term(params, msa_b, w_b):
        h_b, w2_b = params
        x, maskq = _prep_msa(msa_b, l, q, dtype)
        logits = (
            jax.lax.dot_general(
                x.reshape(-1, l * q), w2_b,
                dimension_numbers=(((1,), (0,)), ((), ())),
            ).reshape(-1, q, l)
            + h_b.T[None]
        )
        lse = _lse_q(logits)
        picked = jnp.sum(jnp.where(maskq, logits, 0), axis=1)
        return jnp.sum(w_b[:, None] * (lse - picked))

    def body(carry, blk):
        acc_f, acc_gh, acc_gw = carry
        msa_b, w_b = blk
        f_b, (gh_b, gw_b) = jax.value_and_grad(data_term)((h, w2), msa_b, w_b)
        return (acc_f + f_b, acc_gh + gh_b, acc_gw + gw_b), None

    init = (jnp.zeros((), dtype), jnp.zeros_like(h), jnp.zeros_like(w2))
    (nll, gh, gw2), _ = jax.lax.scan(body, init, (msa_blocks, w_blocks))

    # project the accumulated cotangent onto the symmetric zero-diag space
    mirror = gw2.reshape(l, q, q, l).transpose(3, 2, 1, 0).reshape(l * q, q * l)
    gsym = _combine_w2_projection(gw2, mirror, l, q)

    loss = (
        nll + lambda_h * jnp.sum(h * h) + 0.5 * lambda_j * jnp.sum(w2 * w2)
    )
    grad = jnp.concatenate(
        [
            (gh + 2.0 * lambda_h * h).reshape(-1),
            (gsym.reshape(-1) + lambda_j * z[l * q :]),
        ]
    )
    return loss, grad


# ------------------------------------------------------ fused direction loop
#
# The production full-batch optimizer (r5).  The classic structure —
# opaque fun(x) -> (f, g) evaluated at every line-search trial — pays the
# coupling expansion and its pullback per EVALUATION and moves several
# D-sized vectors per trial; at PF02826 scale (D = 8.35M) that machinery
# dominated the fit wall.  This loop restructures the iteration
# around two linearities:
#
# 1. logits are LINEAR along a search direction: with u = x1h @ E(d_J) +
#    d_h, logits(theta + alpha*d) = logits(theta) + alpha*u.  The carried
#    logits tensor makes every line-search trial a single fused
#    elementwise pass (no matmul, no expansion, no D-vectors), and the
#    regularizer along the line is an exact quadratic in alpha — so the
#    strong-Wolfe search runs entirely on scalars (ops/lbfgs.wolfe_scalar).
# 2. the L-BFGS direction needs only Z @ g and Z @ Z.T for the stacked
#    history Z = [S; Y] (compact representation) — both are CACHED in the
#    state and updated by scalar recurrences (s = alpha*d, y = g' - g, and
#    Z @ d = -(gamma*Zg + ZZt @ c) are all linear-algebra identities on
#    already-known quantities), so the history is read exactly twice per
#    iteration: the direction matmul Z.T @ c and the refresh Z @ g'.
#
# Per-iteration cost = 2 skinny history matmuls + 1 coupling expansion
# (of d) + 2 logits matmuls (u and the backward) + 1 pullback + a few
# D-axpys.  Replaces: pydca/plmdca/plmdcaBackend.cpp:47-94 (driver) +
# lbfgs.cpp (MoreThuente) + plmdca_numerics.cpp:436-607 (gradient), with
# identical convergence semantics to the generic loop above.
#
# Representation note: every parameter-space vector in the fused state is
# a SPLIT PAIR ``(v_h (L*q,), v_j (P*q*q,))`` rather than one flat D
# vector.  Slicing ``theta[l*q:]`` out of a flat vector and feeding it to
# the expansion's row-gather is an XLA compile pathology at protein shape
# (14-25 s per program vs ~3 s with separate operands — r5 cold-compile
# bisection; barriers and dynamic-slice variants measured no better), and
# every inner product is just the sum of the two parts' dots.


def _sv_dot(a, b):
    """Inner product of two split-pair vectors."""
    return jnp.vdot(a[0], b[0]) + jnp.vdot(a[1], b[1])


def _sv_axpy(x, alpha, y):
    """x + alpha * y on split pairs."""
    return (x[0] + alpha * y[0], x[1] + alpha * y[1])


class PlmFusedState(NamedTuple):
    """State of the fused plm L-BFGS loop (a serializable pytree).

    Carries the caches that make the iteration traffic-lean: the carried
    logits/picked tensors (linearity #1) and the history projections
    zg = Z @ g, zzt = Z @ Z.T plus the scalar squares (linearity #2).
    Vectors are split (h, J) pairs — see the representation note above.
    """

    x: Tuple[jax.Array, jax.Array]
    f: jax.Array
    g: Tuple[jax.Array, jax.Array]
    # history rows as 2m SEPARATE split-pair leaves: 0..m-1 = S, m..2m-1
    # = Y.  A stacked (2m, D) buffer forces a full-buffer copy per slot
    # write inside lax.while_loop when dynamic_update_slice with a traced
    # index does not alias in place; writing leaves through a lax.switch
    # whose other branches pass rows through untouched aliases in place.
    z: Tuple[Tuple[jax.Array, jax.Array], ...]
    zzt: jax.Array  # (2m, 2m) Gram cache
    zg: jax.Array  # (2m,) Z @ g cache
    gg: jax.Array  # ||g||^2
    xx: jax.Array  # ||x||^2 (scalar recurrence)
    rh: jax.Array  # ||h||^2
    rj: jax.Array  # ||theta_J||^2
    logits: jax.Array  # (N, q, L) carried logits at x
    picked: jax.Array  # (N, L) carried picked-state logits
    k: jax.Array
    done: jax.Array
    converged: jax.Array
    ls_failed: jax.Array
    n_evals: jax.Array

    def theta(self) -> jax.Array:
        """Reference-layout flat parameter vector [h; J]."""
        return jnp.concatenate([self.x[0], self.x[1]])

    def gnorm(self) -> jax.Array:
        return jnp.sqrt(self.gg)


def _mm_b4(x3, ct, mm_bf16: bool):
    """Backward logits matmul: ``x3 (n, j, b)`` x ``ct (n, a, i)``
    contracting n -> the 4-D ``(j, b, a, i)`` cotangent."""
    mm_dtype = jnp.bfloat16 if mm_bf16 else x3.dtype
    acc = jnp.float32 if mm_bf16 else x3.dtype
    return jax.lax.dot_general(
        x3.astype(mm_dtype),
        ct.astype(mm_dtype),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=acc,
    )


def _w4_cot_to_compact(gw4: jax.Array, l: int, q: int) -> jax.Array:
    """Pull a raw (j, b, a, i) logits-operand cotangent back to the flat
    pair layout.

    The compact gradient of pair (i < j) receives its own (i, j) block
    plus the transposed (j, i) block.  Implementation notes:
    - the gathers run on a 2-D whole-row view of the materialized
      transpose, not on (q, q) blocks through a fused transpose;
    - the chain is entered through a contiguity-preserving 2-D reshape of
      the matmul output; the same ops written against the 4-D value
      compiled far slower.
    """
    gw2 = gw4.reshape(l * q, q * l)  # bitcast view of the matmul output
    gj4 = gw2.reshape(l, q, q, l).transpose(3, 0, 2, 1)  # (i, j, a, b)
    return _pair_pullback_rows(gj4.reshape(l * l, q * q), l, q)


def _expand_w4(j_flat: jax.Array, l: int, q: int) -> jax.Array:
    """Flat pair couplings -> the 4-D (j, b, a, i) matmul operand.

    Deliberately NOT reshaped to (Lq, qL): reshaping the transposed
    tensor costs 30-95 s of XLA compile at PF02826 shape (r5 bisection);
    :func:`_logits_mm` contracts the (j, b) dims directly instead.
    """
    return _expand_full(j_flat, l, q).transpose(1, 3, 2, 0)


def _prep_u(x1h, maskq, d, l: int, q: int, mm_bf16: bool):
    """Direction image in logits space: u = x1h @ E(d_J) + d_h (once per
    direction), plus its picked-state reduction.  ``d`` is a split pair."""
    dh = d[0].reshape(l, q)
    w4d = _expand_w4(d[1], l, q)
    u = _logits_mm(x1h, w4d, mm_bf16) + dh.T[None]
    upicked = jnp.sum(jnp.where(maskq, u, 0), axis=1)
    return u, upicked


def _phi_dphi(logits, picked, u, upicked, weights, alpha):
    """phi(alpha) data term and its derivative: one fused elementwise pass.

    Exploits logits(alpha) = logits + alpha*u: no matmul, no expansion —
    softmax statistics and the ct.u contraction fall out of the same pass.
    """
    t = logits + alpha * u
    mx = jnp.max(t, axis=1)
    e = jnp.exp(t - mx[:, None, :])
    se = jnp.sum(e, axis=1)  # (N, L)
    lse = mx + jnp.log(se)
    pk = picked + alpha * upicked
    nll = jnp.sum(weights[:, None] * (lse - pk))
    su = jnp.sum(e * u, axis=1) / se  # E_softmax[u]  (N, L)
    dnll = jnp.sum(weights[:, None] * (su - upicked))
    return nll, dnll


def _nll_at(logits, picked, weights):
    """Weighted negative log-pseudolikelihood from carried logits/picked
    (the alpha = 0 special case of :func:`_phi_dphi`'s value path)."""
    mx = jnp.max(logits, axis=1)
    lse = mx + jnp.log(jnp.sum(jnp.exp(logits - mx[:, None, :]), axis=1))
    return jnp.sum(weights[:, None] * (lse - picked))


def _ct_gh(logits, maskq, weights):
    """Logits cotangent w*(softmax - onehot) and its sequence-sum (the h
    gradient), recomputed once per accepted iterate."""
    mx = jnp.max(logits, axis=1)
    e = jnp.exp(logits - mx[:, None, :])
    sm = e / jnp.sum(e, axis=1)[:, None, :]
    ct = weights[:, None, None] * (sm - maskq.astype(sm.dtype))
    gh = jnp.sum(ct, axis=0)  # (q, L)
    return ct, gh


def _grad_at(logits, x1h, maskq, weights, x, lambda_h, lambda_j,
             l: int, q: int, mm_bf16: bool):
    """Full split gradient at the carried logits / parameter pair."""
    ct, gh = _ct_gh(logits, maskq, weights)
    gw4 = _mm_b4(x1h, ct, mm_bf16)
    gj = _w4_cot_to_compact(gw4, l, q)
    h = x[0].reshape(l, q)
    g_h = (gh.T + 2.0 * lambda_h * h).reshape(-1)
    g_j = gj + 2.0 * lambda_j * x[1]
    return (g_h, g_j)


def _fused_state_from_theta(
    theta_h, theta_j, z, k, converged, ls_failed, n_evals,
    x1h, maskq, weights, lambda_h, lambda_j, l: int, q: int,
    mm_bf16: bool, epsilon: float = 1e-3,
):
    """Build a full PlmFusedState at ``(theta_h, theta_j)``: one forward +
    one gradient.

    Used for the fresh start (J = 0) and for resuming from a generic
    (non-fused) checkpoint; the caches (zzt, zg, logits) are recomputed,
    so cross-format resume is exact to float recompute, not bitwise —
    fused checkpoints carry the caches and resume bitwise.
    ``z``: sequence of 2m split pairs (or arrays splittable at l*q).
    """
    lq = l * q
    dtype = theta_h.dtype
    x = (theta_h, theta_j)
    h = theta_h.reshape(l, q)
    w4 = _expand_w4(theta_j, l, q)
    logits = _logits_mm(x1h, w4, mm_bf16) + h.T[None]
    picked = jnp.sum(jnp.where(maskq, logits, 0), axis=1)
    rh = jnp.vdot(theta_h, theta_h)
    rj = jnp.vdot(theta_j, theta_j)
    f = (
        _nll_at(logits, picked, weights) + lambda_h * rh + lambda_j * rj
    ).astype(dtype)
    g = _grad_at(logits, x1h, maskq, weights, x, lambda_h, lambda_j, l, q,
                 mm_bf16)
    g = (g[0].astype(dtype), g[1].astype(dtype))
    gg = _sv_dot(g, g)
    xx = rh + rj
    conv0 = jnp.sqrt(gg) / jnp.maximum(jnp.sqrt(xx), 1.0) <= epsilon
    rows = tuple(
        r if isinstance(r, tuple) else (r[:lq], r[lq:]) for r in z
    )
    # one-time Gram/projection rebuild: stack the parts and use two small
    # matmuls (2m x 2m scalars) instead of (2m)^2 separate reductions
    zh = jnp.stack([r[0] for r in rows]).astype(dtype)
    zj = jnp.stack([r[1] for r in rows]).astype(dtype)
    zzt = (zh @ zh.T + zj @ zj.T).astype(dtype)
    zg = (zh @ g[0] + zj @ g[1]).astype(dtype)
    return PlmFusedState(
        x=x, f=f, g=g, z=rows,
        zzt=zzt, zg=zg,
        gg=gg, xx=xx, rh=rh, rj=rj,
        logits=logits, picked=picked,
        k=jnp.asarray(k, jnp.int32),
        done=jnp.asarray(converged, bool) | conv0,
        converged=jnp.asarray(converged, bool) | conv0,
        ls_failed=jnp.asarray(ls_failed, bool),
        n_evals=jnp.asarray(n_evals, jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("l", "q", "m", "mm_bf16", "hist_bf16", "epsilon"),
)
def _plm_fused_state0(
    msa, weights, lambda_h, lambda_j, l: int, q: int, m: int,
    mm_bf16: bool = False, hist_bf16: bool = False,
    epsilon: float = 1e-3,
):
    x1h, maskq = _prep_msa(msa, l, q, jnp.float32)
    lq = l * q
    p = l * (l - 1) // 2
    n = msa.shape[0]
    dtype = jnp.float32
    # reference init (plmdca_numerics.cpp:207-249) built directly as the
    # split pair: slicing a concatenated theta would re-introduce the
    # slice->gather compile pathology inside this very program
    fi = stats.single_site_freqs(msa, weights, q)
    meff = jnp.sum(weights)
    h0 = jnp.log(fi * meff + 1.0)
    h0 = h0 - jnp.mean(h0, axis=1, keepdims=True)
    theta_h = h0.reshape(-1).astype(dtype)
    theta_j = jnp.zeros((p * q * q,), dtype)
    # J0 = 0 exactly: logits are the broadcast fields (no expansion, no
    # forward matmul) and the empty history's Gram caches are zeros —
    # this program then avoids the coupling-expansion composition whose
    # compile is slow; the
    # general _fused_state_from_theta is only traced on checkpoint resume
    logits = jnp.zeros((n, q, l), dtype) + h0.T[None]
    picked = jnp.sum(jnp.where(maskq, logits, 0), axis=1)
    rh = jnp.vdot(theta_h, theta_h)
    rj = jnp.zeros((), dtype)
    f = (_nll_at(logits, picked, weights) + lambda_h * rh).astype(dtype)
    x = (theta_h, theta_j)
    g = _grad_at(logits, x1h, maskq, weights, x, lambda_h, lambda_j, l, q,
                 mm_bf16)
    g = (g[0].astype(dtype), g[1].astype(dtype))
    gg = _sv_dot(g, g)
    xx = rh
    conv0 = jnp.sqrt(gg) / jnp.maximum(jnp.sqrt(xx), 1.0) <= epsilon
    hist_dtype = jnp.bfloat16 if hist_bf16 else jnp.float32
    zero = (
        jnp.zeros((lq,), hist_dtype),
        jnp.zeros((p * q * q,), hist_dtype),
    )
    z = tuple(zero for _ in range(2 * m))
    return PlmFusedState(
        x=x, f=f, g=g, z=z,
        zzt=jnp.zeros((2 * m, 2 * m), dtype),
        zg=jnp.zeros((2 * m,), dtype),
        gg=gg, xx=xx, rh=rh, rj=rj,
        logits=logits, picked=picked,
        k=jnp.asarray(0, jnp.int32),
        done=conv0, converged=conv0,
        ls_failed=jnp.asarray(False, bool),
        n_evals=jnp.asarray(1, jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("l", "q", "num_steps", "mm_bf16"),
    donate_argnums=(0,),
)
def _plm_fused_steps(
    state: PlmFusedState, x1h, maskq, weights, lambda_h, lambda_j,
    l: int, q: int, num_steps: int, mm_bf16: bool = False,
    epsilon: float = 1e-3, ftol: float = 1e-4, wolfe: float = 0.9,
    max_linesearch: int = 10,
):
    """Advance the fused optimizer by up to ``num_steps`` iterations."""
    m = len(state.z) // 2
    dtype = state.f.dtype
    k_start = state.k

    def cond(st: PlmFusedState):
        return jnp.logical_and(~st.done, st.k < k_start + num_steps)

    def body(st: PlmFusedState):
        gamma_eff, cfull, _dg0e, _dn2e = direction_coeffs(
            st.zg, st.zzt, st.gg, st.k, m
        )
        zc_h = functools.reduce(
            lambda a, b: a + b,
            [cfull[r] * st.z[r][0].astype(dtype) for r in range(2 * m)],
        )
        zc_j = functools.reduce(
            lambda a, b: a + b,
            [cfull[r] * st.z[r][1].astype(dtype) for r in range(2 * m)],
        )
        d = (-(gamma_eff * st.g[0] + zc_h), -(gamma_eff * st.g[1] + zc_j))
        # direct fused reductions over (d, g, x): the estimates from
        # direction_coeffs can lose low bits to cancellation; the line
        # search and the scalar recurrences get exact values
        dg0 = _sv_dot(st.g, d)
        # steepest-descent fallback on the EXACT dg0: direction_coeffs
        # gates on its scalar-cache estimate, which can disagree near
        # convergence (bf16 history rounding / cache drift); searching a
        # non-descent direction would terminate prematurely where the
        # generic loop recovers with d = -g (review r5).  Rare path: the
        # conditional executes the copy only when taken.
        bad_dir = dg0 >= 0
        d = jax.lax.cond(
            bad_dir,
            lambda dd: (-st.g[0], -st.g[1]),
            lambda dd: dd,
            d,
        )
        dg0 = jnp.where(bad_dir, -st.gg, dg0)
        dh2 = jnp.vdot(d[0], d[0])
        dj2 = jnp.vdot(d[1], d[1])
        dnorm2 = jnp.maximum(dh2 + dj2, 1e-30)
        hd = jnp.vdot(st.x[0], d[0])
        jd = jnp.vdot(st.x[1], d[1])
        c1 = 2.0 * (lambda_h * hd + lambda_j * jd)
        c2 = lambda_h * dh2 + lambda_j * dj2
        reg0 = lambda_h * st.rh + lambda_j * st.rj

        u, upicked = _prep_u(x1h, maskq, d, l, q, mm_bf16)

        def phi(alpha):
            nll, dnll = _phi_dphi(
                st.logits, st.picked, u, upicked, weights, alpha
            )
            return (
                nll + reg0 + c1 * alpha + c2 * alpha * alpha,
                dnll + c1 + 2.0 * c2 * alpha,
            )

        step0 = jnp.where(
            st.k == 0, 1.0 / jnp.sqrt(dnorm2), 1.0
        ).astype(dtype)
        alpha, f_new, took, rounding, trials = wolfe_scalar(
            phi, st.f, dg0.astype(dtype), step0,
            jnp.array(ftol, dtype), jnp.array(wolfe, dtype), max_linesearch,
        )

        # ---- accept: alpha = 0 when no step -> updates no-op bitwise
        x_new = _sv_axpy(st.x, alpha, d)
        logits_new = st.logits + alpha * u
        picked_new = st.picked + alpha * upicked
        g_new = _grad_at(
            logits_new, x1h, maskq, weights, x_new, lambda_h, lambda_j,
            l, q, mm_bf16,
        )
        g_new = (g_new[0].astype(dtype), g_new[1].astype(dtype))

        gg_new = _sv_dot(g_new, g_new)
        gog = _sv_dot(st.g, g_new)
        dgn = _sv_dot(d, g_new)
        xd = hd + jd
        xx_new = jnp.maximum(
            st.xx + 2.0 * alpha * xd + alpha * alpha * dnorm2, 0.0
        )
        rh_new = st.rh + 2.0 * alpha * hd + alpha * alpha * dh2
        rj_new = st.rj + 2.0 * alpha * jd + alpha * alpha * dj2

        # ---- history: leaf writes behind a switch (aliasing-friendly,
        # see the PlmFusedState.z note), Gram bordered by scalar algebra
        hist_dtype = st.z[0][0].dtype
        s_row = ((alpha * d[0]).astype(hist_dtype),
                 (alpha * d[1]).astype(hist_dtype))
        y_row = ((g_new[0] - st.g[0]).astype(hist_dtype),
                 (g_new[1] - st.g[1]).astype(hist_dtype))
        sy = alpha * (dgn - dg0)
        slot = jnp.mod(st.k, m)
        do_update = took & (sy > 1e-10)

        def _write_slot(r):
            def br(rows):
                lst = list(rows)
                lst[r] = s_row
                lst[r + m] = y_row
                return tuple(lst)
            return br

        z_new = jax.lax.cond(
            do_update,
            lambda rows: jax.lax.switch(
                slot, [_write_slot(r) for r in range(m)], rows
            ),
            lambda rows: rows,
            st.z,
        )
        zg_new = jnp.stack(
            [
                jnp.sum(row[0].astype(dtype) * g_new[0])
                + jnp.sum(row[1].astype(dtype) * g_new[1])
                for row in z_new
            ]
        ).astype(dtype)

        # new-row Gram entries against the OLD slots come from identities:
        # Z@s = alpha * Z@d = -alpha*(gamma*Zg + ZZt@c);  Z@y = Z@g' - Z@g
        # (under the exact-dg0 fallback d = -g, Z@d collapses to -Zg)
        zd = jnp.where(
            bad_dir, -st.zg, -(gamma_eff * st.zg + st.zzt @ cfull)
        )
        zs_vec = (alpha * zd).at[slot].set(alpha * alpha * dnorm2)
        zs_vec = zs_vec.at[slot + m].set(sy)
        zy_vec = (zg_new - st.zg).at[slot].set(sy)
        zy_vec = zy_vec.at[slot + m].set(gg_new - 2.0 * gog + st.gg)
        zzt_new = st.zzt.at[slot, :].set(zs_vec).at[:, slot].set(zs_vec)
        zzt_new = (
            zzt_new.at[slot + m, :].set(zy_vec).at[:, slot + m].set(zy_vec)
        )
        zzt_new = jnp.where(do_update, zzt_new, st.zzt)

        conv = jnp.sqrt(gg_new) / jnp.maximum(jnp.sqrt(xx_new), 1.0) <= epsilon
        return PlmFusedState(
            x=x_new, f=f_new, g=g_new, z=z_new,
            zzt=zzt_new, zg=zg_new, gg=gg_new, xx=xx_new,
            rh=rh_new, rj=rj_new,
            logits=logits_new, picked=picked_new,
            k=jnp.where(took, st.k + 1, st.k),
            done=jnp.where(took, conv, True),
            converged=jnp.where(took, conv, st.converged | rounding),
            ls_failed=jnp.where(took, st.ls_failed, ~rounding),
            n_evals=st.n_evals + trials,
        )

    return jax.lax.while_loop(cond, body, state)


def _result_from_fused(state: PlmFusedState) -> LBFGSResult:
    return LBFGSResult(
        x=state.theta(),
        fx=state.f,
        gnorm=jnp.sqrt(state.gg),
        num_iters=state.k,
        converged=state.converged,
        linesearch_failed=state.ls_failed,
        n_evals=state.n_evals,
    )


def _generic_from_fused(state: PlmFusedState):
    """Fused -> generic LBFGSState (for resuming under streaming/w2 paths)."""
    from .ops.lbfgs import LBFGSState

    m = len(state.z) // 2
    dtype = state.f.dtype
    sy_diag = jnp.diagonal(state.zzt[:m, m:])
    rho = jnp.where(sy_diag != 0, 1.0 / jnp.where(sy_diag == 0, 1.0, sy_diag), 0.0)
    rows = [jnp.concatenate([r[0], r[1]]).astype(dtype) for r in state.z]
    return LBFGSState(
        x=state.theta(), f=state.f,
        g=jnp.concatenate([state.g[0], state.g[1]]),
        s_hist=jnp.stack(rows[:m]), y_hist=jnp.stack(rows[m:]),
        rho=rho.astype(dtype),
        k=state.k, done=state.done, converged=state.converged,
        ls_failed=state.ls_failed, n_evals=state.n_evals,
    )


def fit_plm(
    msa: jax.Array,
    weights: jax.Array,
    lambda_h: jax.Array,
    lambda_j: jax.Array,
    l: int,
    q: int,
    *,
    max_iterations: int = 100,
    m: int = 5,
    chunk_size: Optional[int] = 50,
    progress_fn=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    seq_block: Optional[int] = None,
    mm_bf16: Optional[bool] = None,
    mesh=None,
    param_space: str = "auto",
    hist_bf16: Optional[bool] = None,
):
    """Run the full plmDCA optimization; returns an LBFGSResult.

    By default the optimization runs as a sequence of short device programs
    of ``chunk_size`` L-BFGS iterations each, with the explicit optimizer
    state held between calls: this enables per-chunk progress reporting,
    periodic checkpointing of the optimizer state (resume a long run from
    ``checkpoint_path``), and recovery from device errors.
    Set ``chunk_size=None`` for one single fully-fused device program.

    ``seq_block``: when set, evaluate the loss via the streaming
    sequence-chunked path (:func:`plm_loss_and_grad_chunked`) with this
    many sequences per block — use for deep alignments (N ~ 10^5+) whose
    one-hot/logits tensors would not fit in device memory at once.

    ``mesh``: an optional ``('data', 'model')`` device mesh.  Composes with
    ``seq_block``: the ``(nb, block, L)`` sequence blocks are placed
    ``P(None, 'data', None)``, so every scan step streams its block with
    the rows data-parallel across the mesh and GSPMD psums the per-block
    loss/gradient contributions over 'data' — deep alignments use all
    chips (SURVEY section 5(a); previously streaming silently dropped to
    one chip).  For the non-streaming path pass already-sharded
    ``msa``/``weights`` instead (see
    :func:`pydca_tpu.parallel.fit.fit_plm_sharded`).

    ``mm_bf16``: run the logits matmuls (forward and backward) with
    bfloat16 operands and f32 accumulation — double tensor-core throughput
    at a small cost in gradient precision; score *rankings* are preserved
    (CI-tested).  ``None`` (default) resolves via :func:`default_mm_bf16`
    (float32 operands everywhere).

    ``param_space``: ``"auto"`` (default) / ``"w2"`` / ``"compact"``.
    ``"w2"`` runs L-BFGS directly over the full symmetric coupling matrix
    (the matmul operand), deleting the per-evaluation expansion and its
    VJP — cheaper per evaluation, but the optimizer machinery scales with
    the doubled vector size, and ``"auto"`` resolves to the compact
    layout (see
    :func:`_resolve_param_space` for the measured trade-off).  The result
    is converted back to the reference's compact layout either way.
    """
    if mm_bf16 is None:
        mm_bf16 = default_mm_bf16()
    if hist_bf16 is None:
        hist_bf16 = default_hist_bf16()
    w2space = _resolve_param_space(param_space, l, q, m, mm_bf16)
    chunked = seq_block is not None
    if chunked:
        block = int(seq_block)
        if mesh is not None:
            # each block's rows shard over 'data': keep block divisible
            ndata = int(mesh.shape["data"])
            block = -(-block // ndata) * ndata
        if mesh is not None and isinstance(msa, jax.Array):
            # already device-backed (possibly a multi-host global array):
            # block and reshard ON DEVICE — never gather to the host
            msa, weights = _pad_to_blocks_sharded(
                msa, jnp.asarray(weights, jnp.float32), block, l, mesh
            )
        else:
            msa, weights = _pad_to_blocks(np.asarray(msa), weights, block)
            if mesh is not None:
                from jax.sharding import NamedSharding
                from jax.sharding import PartitionSpec as P

                msa = jax.device_put(
                    msa, NamedSharding(mesh, P(None, "data", None))
                )
                weights = jax.device_put(
                    weights, NamedSharding(mesh, P(None, "data"))
                )
    # np.savez appends .npz to a bare path; normalize so the resume
    # existence check and the save target always name the same file
    if checkpoint_path is not None and not checkpoint_path.endswith(".npz"):
        checkpoint_path = checkpoint_path + ".npz"
    import contextlib

    def mesh_ctx():  # fresh context per use (context managers are one-shot)
        return jax.set_mesh(mesh) if mesh is not None else contextlib.nullcontext()

    pidx = jnp.asarray(stats.pair_index_matrix(l))
    # the fused direction loop is the production full-batch compact path;
    # streaming (seq_block) and w2-space runs use the generic fun-based loop
    use_fused = not chunked and not w2space
    state = None
    done_iters = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state = _load_state(checkpoint_path)
        if isinstance(state, PlmFusedState):
            if not use_fused:
                # continue under the generic loop (flags changed between
                # runs); the caches convert exactly, resume is not bitwise
                state = _generic_from_fused(state)
        if not isinstance(state, PlmFusedState):
            # a checkpoint written in the other parameter space wins: its
            # history vectors cannot be converted, only continued
            ckpt_w2 = state.x.size == l * q + (l * q) * (q * l)
            if ckpt_w2 != w2space:
                logger.info(
                    "checkpoint is in %s space; continuing in that space",
                    "w2" if ckpt_w2 else "compact",
                )
                w2space = ckpt_w2
                use_fused = not chunked and not w2space
        done_iters = int(state.k)
        logger.info("resumed plmDCA optimizer state at iteration %d", done_iters)
    if use_fused:
        weights = jnp.asarray(weights, jnp.float32)
        with mesh_ctx():
            x1h, maskq = _prep_msa_jit(msa, l, q)
            if state is None:
                state = _plm_fused_state0(
                    msa, weights, lambda_h, lambda_j, l, q, m, mm_bf16,
                    hist_bf16,
                )
            elif not isinstance(state, PlmFusedState):
                # generic-format checkpoint (older run / other path):
                # rebuild the fused caches at the checkpointed iterate
                state = _fused_from_generic_jit(
                    state, x1h, maskq, weights, lambda_h, lambda_j, l, q,
                    mm_bf16,
                )
    elif state is None:
        with mesh_ctx():
            state = _plm_lbfgs_state0(
                msa, weights, pidx, lambda_h, lambda_j, l, q, m, chunked,
                mm_bf16, w2space,
            )

    step = max_iterations if chunk_size is None else int(chunk_size)
    last_saved = done_iters
    is_done = bool(state.done)
    retries = 2  # elastic recovery: device/runtime failures mid-chunk
    # Per-chunk (k, done) fetches each pay a device->host round trip.
    # They are only needed when the host must OBSERVE progress
    # (logging, checkpointing, retry bookkeeping); otherwise dispatch all
    # chunks optimistically — a chunk whose while-loop is already done
    # no-ops in ~a dispatch.
    need_sync = progress_fn is not None or checkpoint_path is not None
    while done_iters < max_iterations and not is_done:
        todo = min(step, max_iterations - done_iters)
        try:
            with mesh_ctx():
                if use_fused:
                    state = _plm_fused_steps(
                        state, x1h, maskq, weights, lambda_h, lambda_j,
                        l, q, todo, mm_bf16,
                    )
                else:
                    state = _plm_lbfgs_steps(
                        state, msa, weights, pidx, lambda_h, lambda_j, l, q,
                        todo, chunked, mm_bf16, w2space,
                    )
            if not need_sync:
                done_iters += todo  # optimistic; real k rides in the result
                continue
            # one device->host fetch per chunk (state.k and state.done
            # ride together)
            done_iters, is_done = jax.device_get((state.k, state.done))
        except RuntimeError as exc:
            # e.g. XlaRuntimeError ABORTED on a preempted/flaky device: the
            # device state is gone, but the host checkpoint survives — the
            # chunked-program structure exists precisely so a long fit can
            # lose at most checkpoint_every iterations.
            if (
                retries <= 0
                or checkpoint_path is None
                or not os.path.exists(checkpoint_path)
            ):
                raise
            retries -= 1
            logger.warning(
                "device error during L-BFGS chunk (%s); resuming from "
                "checkpoint %s (%d retries left)",
                exc, checkpoint_path, retries,
            )
            state = _load_state(checkpoint_path)
            if use_fused and not isinstance(state, PlmFusedState):
                state = _fused_from_generic_jit(
                    state, x1h, maskq, weights, lambda_h, lambda_j, l, q,
                    mm_bf16,
                )
            elif not use_fused and isinstance(state, PlmFusedState):
                state = _generic_from_fused(state)
            done_iters, is_done = int(state.k), bool(state.done)
            continue
        done_iters = int(done_iters)
        if progress_fn is not None:
            progress_fn(state)
        if checkpoint_path is not None and (
            done_iters - last_saved >= checkpoint_every or bool(is_done)
        ):
            _save_state(checkpoint_path, state)
            last_saved = done_iters
    if use_fused:
        return _result_from_fused(state)
    res = result_from_state(state)
    if w2space:
        # back to the reference's compact flat layout for the API surface
        res = res._replace(x=z_to_theta(res.x, l, q))
    return res


@functools.partial(jax.jit, static_argnames=("l", "q"))
def _prep_msa_jit(msa, l: int, q: int):
    return _prep_msa(msa, l, q, jnp.float32)


@functools.partial(jax.jit, static_argnames=("l", "q", "mm_bf16"))
def _fused_from_generic_jit(
    gstate, x1h, maskq, weights, lambda_h, lambda_j, l: int, q: int,
    mm_bf16: bool,
):
    lq = l * q
    z = tuple(
        (row[:lq], row[lq:])
        for hist in (gstate.s_hist, gstate.y_hist)
        for row in hist
    )
    st = _fused_state_from_theta(
        gstate.x[:lq], gstate.x[lq:], z, gstate.k, gstate.converged,
        gstate.ls_failed, gstate.n_evals, x1h, maskq, weights, lambda_h,
        lambda_j, l, q, mm_bf16,
    )
    return st._replace(done=st.done | gstate.done)


# Memory budgets, as shares of the device's allocatable memory (CPU keeps
# fixed byte counts).  w2 space: the optimizer holds ~(2m + 4) vectors of
# Lq + (Lq)^2 floats (x, g, direction, temps, m s/y pairs), kept under 3/8
# of the device next to the one-hot data.  Streaming: the full-batch fit
# carries the (N, q, L) logits plus several same-sized temporaries, so it
# streams once one logits tensor would pass 1/16 of the device.
W2SPACE_FRACTION, W2SPACE_CPU_BYTES = 3 / 8, 6 << 30
STREAM_FRACTION, STREAM_CPU_BYTES = 1 / 16, 1 << 30


def auto_seq_block(n: int, l: int, q: int) -> Optional[int]:
    """Streaming block for an (N, L, q) fit, or ``None`` to run full-batch:
    stream once the f32 logits tensor would pass the streaming budget."""
    budget = runtime.memory_budget(STREAM_FRACTION, STREAM_CPU_BYTES)
    if 4 * n * l * q <= budget:
        return None
    return max(1024, budget // (4 * l * q))


def _resolve_param_space(param_space: str, l: int, q: int, m: int, mm_bf16):
    """``auto`` resolves to the compact reference layout — on every backend.

    r4 measured w2 ~3x faster end-to-end on CPU (the per-evaluation
    coupling expansion dominated there), so auto was slated to become
    backend-aware.  The r5 fused direction loop (expansion once per
    DIRECTION, scalar line search, cached history projections) erased
    that gap: on the CPU, PF02826 for 10 iterations took 37 s compact
    against 45 s in w2, and RF00167 for 30 iterations 1.69 against 1.70 s.
    So ``auto`` resolves to compact; the GPU comparison is not measured.  w2 remains an explicit option (its
    trajectory differs — a different inner-product geometry — which can
    reach a lower fx in few-iteration budgets), guarded by the memory
    gate below.
    """
    if param_space == "compact":
        return False
    if param_space != "w2":
        if param_space != "auto":
            raise PlmDCAException(
                f"invalid param_space {param_space!r}; "
                "choose auto, w2 or compact"
            )
        return False
    if mm_bf16:
        # the w2 path keeps f32 operands (its matmuls are the whole eval);
        # honor an explicit bf16 request via the compact path
        logger.warning(
            "param_space='w2' does not support bfloat16 operands; "
            "running the compact parameterization instead"
        )
        return False
    vec_bytes = 4 * (l * q + (l * q) * (q * l))
    if vec_bytes * (2 * m + 4) > runtime.memory_budget(
        W2SPACE_FRACTION, W2SPACE_CPU_BYTES
    ):
        logger.warning(
            "param_space='w2' needs ~%.1f GiB of optimizer vectors at "
            "L=%d, q=%d; falling back to compact",
            vec_bytes * (2 * m + 4) / 2**30, l, q,
        )
        return False
    return True


def _save_state(path: str, state) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    if isinstance(state, PlmFusedState) and not (
        state.logits.is_fully_addressable
    ):
        # multi-host run: the carried logits/picked are data-sharded
        # across processes and cannot be np.asarray'd here.  Save the
        # generic form instead (replicated D-vectors only) — resume
        # rebuilds the fused caches (exact to float recompute, not
        # bitwise; single-host checkpoints keep the bitwise guarantee).
        state = _generic_from_fused(state)
    d = state._asdict()
    if isinstance(state, PlmFusedState):
        # flatten split pairs into reference-layout rows; store as float32
        # (npz-portable; bf16 -> f32 -> bf16 roundtrips losslessly so
        # resume stays bitwise)
        d["x"] = np.asarray(state.theta())
        d["g"] = np.asarray(jnp.concatenate([state.g[0], state.g[1]]))
        d["z"] = np.stack(
            [
                np.asarray(jnp.concatenate([r[0], r[1]]).astype(jnp.float32))
                for r in state.z
            ]
        )
        d["z_bf16"] = np.asarray(state.z[0][0].dtype == jnp.bfloat16)
    np.savez(path, **{k: np.asarray(v) for k, v in d.items()})


def _load_state(path: str):
    from .ops.lbfgs import LBFGSState

    z = np.load(path if path.endswith(".npz") else path + ".npz")
    if "zzt" in z.files:  # fused-format checkpoint: caches ride along so
        # resume is bitwise (logits/Grams are NOT recomputed)
        vals = {k: jnp.asarray(z[k]) for k in PlmFusedState._fields}
        _, qn, ln = z["logits"].shape
        lq = qn * ln
        zmat = vals["z"]  # pair leaves saved stacked as (2m, D) float32
        if "z_bf16" in z.files and bool(z["z_bf16"]):
            zmat = zmat.astype(jnp.bfloat16)
        vals["z"] = tuple(
            (zmat[i, :lq], zmat[i, lq:]) for i in range(zmat.shape[0])
        )
        vals["x"] = (vals["x"][:lq], vals["x"][lq:])
        vals["g"] = (vals["g"][:lq], vals["g"][lq:])
        return PlmFusedState(**vals)
    vals = {}
    for k in LBFGSState._fields:
        if k in z.files:
            vals[k] = jnp.asarray(z[k])
        elif k == "n_evals":  # checkpoints from before the eval counter
            vals[k] = jnp.array(0, jnp.int32)
        else:
            raise KeyError(f"checkpoint missing field {k}")
    return LBFGSState(**vals)


# ----------------------------------------------------------------- engine class
class PlmDCA:
    """Pseudolikelihood maximization DCA.

    Mirrors the reference API (``pydca/plmdca/plmdca.py:47-104``): defaults
    ``seqid=0.8``, ``lambda_h = lambda_J = 0.2*(L-1)``, ``max_iterations=100``.
    ``num_threads`` is accepted for interface compatibility and ignored (the
    device replaces OpenMP).
    """

    def __init__(
        self,
        msa_file,
        biomolecule: str,
        seqid: Optional[float] = None,
        lambda_h: Optional[float] = None,
        lambda_J: Optional[float] = None,
        max_iterations: Optional[int] = None,
        num_threads: Optional[int] = None,
        verbose: bool = False,
        checkpoint_path: Optional[str] = None,
        seq_block: Optional[int] = None,
        precision: Optional[str] = None,
        mesh=None,
        param_space: str = "auto",
    ):
        if isinstance(msa_file, MSA):
            self.msa = msa_file
        else:
            self.msa = read_msa(msa_file, biomolecule)
        self.__seqid = 0.8 if seqid is None else float(seqid)
        if not 0.0 < self.__seqid <= 1.0:
            raise PlmDCAException(f"invalid seqid {self.__seqid}")
        l = self.msa.seqs_len
        self.__lambda_h = 0.2 * (l - 1) if lambda_h is None else float(lambda_h)
        self.__lambda_j = 0.2 * (l - 1) if lambda_J is None else float(lambda_J)
        if self.__lambda_h < 0 or self.__lambda_j < 0:
            raise PlmDCAException("lambda_h and lambda_J must be non-negative")
        self.__max_iterations = 100 if max_iterations is None else int(max_iterations)
        if seq_block is None:
            seq_block = auto_seq_block(self.msa.num_seqs, l, self.msa.q)
        self.__seq_block = seq_block
        self.__mm_bf16 = resolve_precision(precision)
        if param_space not in ("auto", "w2", "compact"):
            raise PlmDCAException(
                f"invalid param_space {param_space!r}; "
                "choose auto, w2 or compact"
            )
        self.__param_space = param_space
        from .meanfield import _resolve_mesh

        # multi-chip: mesh="auto" shards sequences data-parallel over all
        # visible devices.  Composes with streaming (seq_block): each
        # (block, L) scan step is itself sharded P('data', None), so deep
        # alignments stream on ALL chips (fit_plm's mesh parameter).
        self.__mesh = _resolve_mesh(mesh)
        self.__verbose = bool(verbose)
        self.__checkpoint_path = checkpoint_path
        self.__params: Optional[np.ndarray] = None
        self.__weights = None
        self.__refseq_mapping_dict = None
        self.__fit_result = None
        self.timers = StageTimers()

    # ------------------------------------------------------------- properties
    @property
    def biomolecule(self):
        return self.msa.alphabet.name

    @property
    def sequence_identity(self):
        return self.__seqid

    @property
    def lambda_h(self):
        return self.__lambda_h

    @property
    def lambda_J(self):
        return self.__lambda_j

    @property
    def max_iterations(self):
        return self.__max_iterations

    @property
    def mm_bf16(self) -> bool:
        """Whether the logits matmuls run with bfloat16 operands."""
        return self.__mm_bf16

    @property
    def mesh(self):
        """The resolved device mesh (``mesh="auto"`` over several devices),
        or ``None`` on one device."""
        return self.__mesh

    @property
    def sequences_len(self):
        return self.msa.seqs_len

    @property
    def num_sequences(self):
        return self.msa.num_seqs

    @property
    def num_site_states(self):
        return self.msa.q

    @property
    def effective_num_sequences(self):
        return float(jnp.sum(self.compute_seqs_weight()))

    @property
    def fit_result(self):
        return self.__fit_result

    # -------------------------------------------------------------- pipeline
    def compute_seqs_weight(self) -> jax.Array:
        if self.__weights is None:
            with self.timers.stage("weights"):
                if self.__mesh is not None:
                    from .parallel.fit import sequence_weights_sharded

                    self.__weights = sequence_weights_sharded(
                        self.__mesh,
                        jnp.asarray(self.msa.data, jnp.int32),
                        self.__seqid,
                        self.msa.q,
                    )
                else:
                    self.__weights = stats.sequence_weights(
                        jnp.asarray(self.msa.data, jnp.int32),
                        self.__seqid,
                        self.msa.q,
                        dtype=jnp.float32,
                    )
                jax.block_until_ready(self.__weights)
            self.timers.add_rate("weights", self.msa.num_seqs, "seqs")
        return self.__weights

    def get_fields_and_couplings_from_backend(self) -> np.ndarray:
        """Optimize and return the flat float32 parameter vector in the
        reference layout (fields then couplings; ``plmdca.py:202-243``)."""
        if self.__params is None:
            l, q = self.msa.seqs_len, self.msa.q

            def _progress(state):
                gn = (
                    state.gnorm()
                    if hasattr(state, "gnorm")
                    else jnp.linalg.norm(state.g)
                )
                logger.info(
                    "plmDCA iteration %d: fx=%.6f |g|=%.4e",
                    int(state.k),
                    float(state.f),
                    float(gn),
                )

            # only wire the per-chunk callback when it will actually log:
            # a progress_fn forces a device->host (k, done) fetch per chunk
            # (fit_plm's need_sync)
            progress_fn = _progress if self.__verbose else None

            weights = self.compute_seqs_weight()
            with self.timers.stage("fit"):
                if self.__mesh is not None:
                    from .parallel.fit import fit_plm_sharded

                    res = fit_plm_sharded(
                        self.msa.data,
                        biomolecule_q=q,
                        lambda_h=self.__lambda_h,
                        lambda_j=self.__lambda_j,
                        max_iterations=self.__max_iterations,
                        mesh=self.__mesh,
                        weights=weights,
                        progress_fn=progress_fn,
                        checkpoint_path=self.__checkpoint_path,
                        seq_block=self.__seq_block,
                        mm_bf16=self.__mm_bf16,
                        param_space=self.__param_space,
                    )
                else:
                    res = fit_plm(
                        jnp.asarray(self.msa.data, jnp.int32),
                        weights,
                        jnp.float32(self.__lambda_h),
                        jnp.float32(self.__lambda_j),
                        l,
                        q,
                        max_iterations=self.__max_iterations,
                        progress_fn=progress_fn,
                        checkpoint_path=self.__checkpoint_path,
                        seq_block=self.__seq_block,
                        mm_bf16=self.__mm_bf16,
                        param_space=self.__param_space,
                    )
                jax.block_until_ready(res.x)
            self.timers.add_rate("fit", int(res.num_iters), "iters")
            self.__fit_result = res
            if self.__verbose:
                logger.info(
                    "plmDCA L-BFGS: %d iterations, fx=%.6f, |g|=%.3e, "
                    "converged=%s, linesearch_failed=%s",
                    int(res.num_iters),
                    float(res.fx),
                    float(res.gnorm),
                    bool(res.converged),
                    bool(res.linesearch_failed),
                )
                logger.info("plmDCA stage timings:\n%s", self.timers.summary())
            self.__params = np.asarray(res.x, dtype=np.float32)
        return self.__params

    # ------------------------------------------------------- param extraction
    def get_fields_no_gap_state(self, params: Optional[np.ndarray] = None):
        if params is None:
            params = self.get_fields_and_couplings_from_backend()
        l, q = self.msa.seqs_len, self.msa.q
        return params[: l * q].reshape(l, q)[:, : q - 1].reshape(-1)

    def get_couplings_no_gap_state(self, params: Optional[np.ndarray] = None):
        """Flat (P*(q-1)^2,) couplings with gap states dropped
        (``plmdca.py:246-268``)."""
        if params is None:
            params = self.get_fields_and_couplings_from_backend()
        l, q = self.msa.seqs_len, self.msa.q
        p = l * (l - 1) // 2
        jt = params[l * q :].reshape(p, q, q)
        return jt[:, : q - 1, : q - 1].reshape(-1)

    def get_fields_and_couplings_no_gap_state(self, params=None):
        return (
            self.get_fields_no_gap_state(params),
            self.get_couplings_no_gap_state(params),
        )

    def coupling_blocks(self) -> np.ndarray:
        """(P, q-1, q-1) gap-excluded coupling blocks in pair order."""
        l, q = self.msa.seqs_len, self.msa.q
        p = l * (l - 1) // 2
        params = self.get_fields_and_couplings_from_backend()
        return params[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]

    def shift_couplings(self, couplings_ij):
        qm1 = self.msa.q - 1
        return np.asarray(
            score_mod.gauge_shift(jnp.asarray(couplings_ij).reshape(qm1, qm1))
        )

    # ----------------------------------------------------------------- scores
    def _fn_scores(self) -> np.ndarray:
        return np.asarray(
            score_mod.frobenius_norms(jnp.asarray(self.coupling_blocks()))
        )

    def map_index_couplings(self, i, j, a, b) -> int:
        """Flat parameter-vector index of ``J_ij(a, b)`` for a pair ``i < j``
        (reference ``plmdca.py:183-199``; states here are 0-based)."""
        q, l = self.msa.q, self.msa.seqs_len
        site = int(stats.pair_index(i, j, l)) * q * q
        return l * q + site + a * q + b

    def get_single_site_freqs(self) -> jax.Array:
        """Raw weighted ``fi`` of shape (L, q) (reference ``plmdca.py:613-633``)."""
        return stats.single_site_freqs(
            jnp.asarray(self.msa.data, jnp.int32),
            self.compute_seqs_weight(),
            self.msa.q,
        )

    def compute_two_site_model_fields(self, couplings=None) -> np.ndarray:
        """Two-site-model fields, shape ``(P, 2, q)``
        (reference ``plmdca.py:640-678``)."""
        l, q = self.msa.seqs_len, self.msa.q
        if couplings is None:
            blocks = jnp.asarray(self.coupling_blocks())
        else:
            qm1 = q - 1
            blocks = jnp.asarray(couplings).reshape(-1, qm1, qm1)
        hi, hj = score_mod.two_site_model_fields(
            blocks, self.get_reg_single_site_freqs(), l, q
        )
        return np.stack([np.asarray(hi), np.asarray(hj)], axis=1)

    def compute_direct_info_unsorted_DI(self) -> np.ndarray:
        """Unsorted DI per pair, shape ``(P,)`` (reference ``plmdca.py:681-720``)."""
        return self._di_scores()

    def get_mapped_site_pairs_dca_scores(self, sorted_dca_scores, seqbackmapper):
        """Public name of the refseq score filter (reference ``plmdca.py:527-560``)."""
        return self._map_scores(sorted_dca_scores, seqbackmapper)

    def get_reg_single_site_freqs(self) -> jax.Array:
        """fi with the DI path's hard-coded pseudocount 0.5 (``plmdca.py:638-648``)."""
        fi = stats.single_site_freqs(
            jnp.asarray(self.msa.data, jnp.int32),
            self.compute_seqs_weight(),
            self.msa.q,
        )
        return stats.regularize_fi(fi, self.msa.q, 0.5)

    def _di_scores(self) -> np.ndarray:
        return np.asarray(
            score_mod.direct_information(
                jnp.asarray(self.coupling_blocks()),
                self.get_reg_single_site_freqs(),
                self.msa.seqs_len,
                self.msa.q,
            )
        )

    def compute_sorted_FN(self, seqbackmapper=None):
        res = score_mod.sorted_scores(self._fn_scores(), self.msa.seqs_len)
        if seqbackmapper is not None:
            res = self._map_scores(res, seqbackmapper)
        return res

    def compute_sorted_FN_APC(self, seqbackmapper=None):
        apc = score_mod.apc(jnp.asarray(self._fn_scores()), self.msa.seqs_len)
        res = score_mod.sorted_scores(np.asarray(apc), self.msa.seqs_len)
        if seqbackmapper is not None:
            res = self._map_scores(res, seqbackmapper)
        return res

    def compute_sorted_DI(self, seqbackmapper=None):
        res = score_mod.sorted_scores(self._di_scores(), self.msa.seqs_len)
        if seqbackmapper is not None:
            res = self._map_scores(res, seqbackmapper)
        return res

    def compute_sorted_DI_APC(self, seqbackmapper=None):
        apc = score_mod.apc(jnp.asarray(self._di_scores()), self.msa.seqs_len)
        res = score_mod.sorted_scores(np.asarray(apc), self.msa.seqs_len)
        if seqbackmapper is not None:
            res = self._map_scores(res, seqbackmapper)
        return res

    # ----------------------------------------------------------- backmapping
    def _map_scores(self, sorted_dca_scores, seqbackmapper):
        mapping_dict = seqbackmapper.map_to_reference_sequence()
        self.__refseq_mapping_dict = mapping_dict
        mapped = []
        for pair, sc in sorted_dca_scores:
            if pair[0] in mapping_dict and pair[1] in mapping_dict:
                mapped.append(((mapping_dict[pair[0]], mapping_dict[pair[1]]), sc))
        mapped.sort(key=lambda k: k[1], reverse=True)
        return mapped

    # ------------------------------------------------------------ parameters
    def compute_params(
        self,
        seqbackmapper=None,
        ranked_by: Optional[str] = None,
        linear_dist: Optional[int] = None,
        num_site_pairs: Optional[int] = None,
    ):
        """Fields plus top-ranked gauge-shifted couplings (``plmdca.py:345-434``)."""
        if ranked_by is None:
            ranked_by = "fn_apc"
        if linear_dist is None:
            linear_dist = 4
        ranked_by = ranked_by.strip().upper()
        methods = {
            "FN": self.compute_sorted_FN,
            "FN_APC": self.compute_sorted_FN_APC,
            "DI": self.compute_sorted_DI,
            "DI_APC": self.compute_sorted_DI_APC,
        }
        if ranked_by not in methods:
            raise PlmDCAException(
                f"invalid ranking criterion {ranked_by}; choose from {tuple(methods)}"
            )
        dca_scores = methods[ranked_by](seqbackmapper=seqbackmapper)
        l, q = self.msa.seqs_len, self.msa.q
        qm1 = q - 1
        fields = self.get_fields_no_gap_state()
        couplings = self.get_couplings_no_gap_state()
        if seqbackmapper is not None:
            mapping_dict = {v: k for k, v in self.__refseq_mapping_dict.items()}
        else:
            mapping_dict = {i: i for i in range(l)}
        if num_site_pairs is None:
            num_site_pairs = (
                len(seqbackmapper.ref_sequence)
                if seqbackmapper is not None
                else len(mapping_dict)
            )
        fields_mapped = [
            (i, fields[qm1 * mapping_dict[i] : qm1 * mapping_dict[i] + qm1])
            for i in mapping_dict.keys()
        ]
        ranked = []
        count = 0
        for pair, _ in dca_scores:
            s1, s2 = pair
            if abs(s1 - s2) > linear_dist:
                count += 1
                if count > num_site_pairs:
                    break
                i, j = mapping_dict[s1], mapping_dict[s2]
                if i > j:
                    raise PlmDCAException("site pair (i, j) should satisfy i < j")
                k = stats.pair_index(i, j, l)
                block = couplings[k * qm1 * qm1 : (k + 1) * qm1 * qm1]
                ranked.append((pair, self.shift_couplings(block).reshape(qm1 * qm1)))
        return tuple(fields_mapped), tuple(ranked)
