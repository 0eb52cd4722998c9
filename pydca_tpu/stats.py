"""Core MSA statistics as JAX matmuls.

Design
------
The reference computes sequence weights, single-site and pair-site frequencies
with O(N^2 L) / O(L^2 q^2 N) scalar loops (``pydca/meanfield_dca/msa_numerics.py:13-229``,
``pydca/plmdca/plmdca_numerics.cpp:51-140,611-671``).  Here all three are
matmuls over the one-hot encoded alignment ``X in {0,1}^(N, L*q)``:

- identity counts between sequences:  ``S = X @ X.T`` (int8 x int8 -> int32,
  or the fused GPU kernel); weights are ``1 / #{j : S_ij / L > seqid}``,
- the weighted *gram matrix* ``F = X.T @ diag(w) @ X / Meff`` of shape
  ``(L*q, L*q)`` simultaneously contains every single-site frequency (on its
  diagonal) and every pair-site frequency (off-diagonal blocks), so one large
  matmul replaces the reference's entire counting layer,
- the mean-field correlation matrix is an elementwise transform of ``F``.

All functions are jittable with static ``(L, q)``; the N axis may be sharded
data-parallel (see ``pydca_tpu.parallel``) since every contraction over N is a
plain sum that XLA turns into a ``psum``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from . import runtime
from .ops.pallas_kernels import identity_counts

__all__ = [
    "one_hot_msa",
    "sequence_weights",
    "single_site_freqs",
    "weighted_gram",
    "pair_site_freqs",
    "regularize_fi",
    "regularize_fij",
    "corr_mat_from_gram",
    "pair_index",
    "pair_index_matrix",
]

_DEFAULT_BLOCK = 2048

def identity_counts_path() -> str:
    """``"kernel"`` or ``"xla"``: the identity-count implementation that
    :func:`sequence_weights` dispatches.

    The kernel (ops/pallas_kernels.py) runs on the GPU at every depth: on
    an H100 it beat the blocked XLA scan at every depth timed (PERF.md).
    The scan runs on the CPU and is the kernel's reference in the tests.
    """
    return "kernel" if runtime.backend() == "gpu" else "xla"


def one_hot_msa(msa: jax.Array, q: int, dtype=jnp.float32) -> jax.Array:
    """One-hot encode an ``(N, L)`` int MSA to ``(N, L, q)``."""
    return jax.nn.one_hot(msa, q, dtype=dtype)


# --------------------------------------------------------------------- weights
@functools.partial(jax.jit, static_argnames=("q", "block", "has_valid"))
def _sequence_weights_impl(
    msa: jax.Array, thr: jax.Array, q: int, block: int, valid=None,
    has_valid: bool = False,
):
    """Blocked identity-count scan; the one-hot exists only per tile pair.

    Both the row AND column axes are blocked, and each block's one-hot is
    built inside the scan bodies from the int codes — the full ``(N, L*q)``
    one-hot never materializes (at N=10^6, L=1000, q=21 it would be ~21 GB;
    the codes are 1 GB).  XLA keeps one ``(block, L*q)`` tile per operand
    live at a time.
    """
    n, l = msa.shape
    nblocks = -(-n // block)
    npad = nblocks * block
    # pad value -1: one-hots to all-zero rows, matches nothing
    codes = jnp.pad(
        msa.astype(jnp.int8), ((0, npad - n), (0, 0)), constant_values=-1
    )
    if has_valid:
        vmask = valid.astype(jnp.int32)
    else:
        vmask = jnp.ones((n,), jnp.int32)
    vmask = jnp.pad(vmask, (0, npad - n))
    cblocks = codes.reshape(nblocks, block, l)
    vblocks = vmask.reshape(nblocks, block)

    def one_hot8(c):
        return (
            (c[:, :, None] == jnp.arange(q, dtype=c.dtype))
            .astype(jnp.int8)
            .reshape(c.shape[0], l * q)
        )

    def body_i(_, ci):
        xi = one_hot8(ci)

        def body_j(acc, blk):
            cj, vj = blk
            counts = jax.lax.dot_general(
                xi,
                one_hot8(cj),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )  # (block, block)
            ind = (counts.astype(jnp.float32) > thr).astype(jnp.int32)
            # mask out padding/invalid sequences so they never count as
            # neighbors (multi-host shards pad to a common local size)
            ind = ind * vj[None, :]
            return acc + jnp.sum(ind, axis=1, dtype=jnp.int32), None

        sims_i, _ = jax.lax.scan(
            body_j, jnp.zeros((ci.shape[0],), jnp.int32), (cblocks, vblocks)
        )
        return None, sims_i

    _, sims = jax.lax.scan(body_i, None, cblocks)
    return sims.reshape(npad)[:n]


def sequence_weights(
    msa: jax.Array,
    seqid: float,
    q: int,
    *,
    block: int = _DEFAULT_BLOCK,
    dtype=jnp.float32,
    valid=None,
) -> jax.Array:
    """Per-sequence reweighting factors.

    ``w_i = 1 / m_i`` where ``m_i`` counts sequences (including ``i`` itself)
    whose fractional identity with ``i`` exceeds ``seqid`` *strictly*
    (reference: ``pydca/meanfield_dca/msa_numerics.py:41-49``).

    Parameters
    ----------
    msa : (N, L) int array
    seqid : float
        Identity threshold in (0, 1].
    q : int
        Alphabet size (states including gap).
    block : int
        Row-block size for the tiled N x N identity-count matmul; the full
        ``(N, N)`` matrix is never materialized.
    valid : optional (N,) bool array
        Rows with ``valid = False`` (multi-host shard padding) are excluded
        from every neighbor count; their own returned weight is meaningless
        and must be masked by the caller.
    """
    n, l = msa.shape
    blk = min(block, max(8, n))
    # Strict threshold on integer identity counts: iid/L > seqid  <=>  iid > seqid*L
    thr = float(seqid) * l
    has_valid = valid is not None
    if has_valid:
        valid = jnp.asarray(valid)
    if identity_counts_path() == "kernel":
        sims = _kernel_counts(msa, thr, q, valid)
    else:
        sims = _sequence_weights_impl(
            msa, jnp.float32(thr), q, blk, valid, has_valid=has_valid
        )
    if has_valid:
        sims = jnp.maximum(sims, 1)  # pad rows: avoid 1/0; caller masks them
    return _counts_to_weights(sims, dtype)


@functools.partial(jax.jit, static_argnames=("dtype",))
def _counts_to_weights(sims: jax.Array, dtype) -> jax.Array:
    """1/m weights from neighbor counts — one cacheable program (the eager
    astype+divide pair used to cost two per-process compiles)."""
    return (1.0 / sims.astype(dtype)).astype(dtype)


@functools.partial(jax.jit, static_argnames=("thr", "q"))
def _kernel_counts(msa: jax.Array, thr: float, q: int, valid=None):
    """The compiled kernel; under a mesh with a 'data' axis each device
    counts its own rows against the all-gathered alignment."""
    mesh = jax.sharding.get_abstract_mesh()
    ndata = mesh.shape["data"] if "data" in (mesh.axis_names or ()) else 1
    if ndata == 1 or msa.shape[0] % ndata:
        return identity_counts(msa, thr, q, valid)
    from jax.sharding import PartitionSpec as P

    if valid is None:
        valid = jnp.ones(msa.shape[:1], jnp.bool_)
    return jax.shard_map(
        lambda rows, cols, v: identity_counts(rows, thr, q, v, cols=cols),
        mesh=mesh,
        in_specs=(P("data", None), P(), P()),
        out_specs=P("data"),
        check_vma=False,  # pallas_call outputs carry no varying-axis type
    )(msa, msa, valid)


# ------------------------------------------------------------------ frequencies
@functools.partial(jax.jit, static_argnames=("q",))
def single_site_freqs(msa: jax.Array, weights: jax.Array, q: int) -> jax.Array:
    """Weighted single-site frequencies ``fi`` of shape ``(L, q)``.

    ``fi[i, a] = sum_n w_n [msa[n, i] == a] / Meff``
    (reference: ``pydca/meanfield_dca/msa_numerics.py:53-89``).
    """
    meff = jnp.sum(weights)
    x = jax.nn.one_hot(msa, q, dtype=weights.dtype)  # (N, L, q)
    fi = jnp.einsum("n,nlq->lq", weights, x, precision=jax.lax.Precision.HIGHEST)
    return fi / meff


@functools.partial(jax.jit, static_argnames=("q",))
def weighted_gram(msa: jax.Array, weights: jax.Array, q: int) -> jax.Array:
    """Weighted co-occurrence gram matrix ``F`` of shape ``(L*q, L*q)``.

    ``F[(i,a),(j,b)] = sum_n w_n [s_ni == a][s_nj == b] / Meff``.

    Its block-diagonal ``(i == j)`` encodes ``fi`` (``F[(i,a),(i,a)] = fi[i,a]``,
    zero off-diagonal within the block); every ``i != j`` block is the pair
    frequency table ``fij``.  This single matmul subsumes the reference's
    pair-frequency loops (``msa_numerics.py:182-229``, ``plmdca_numerics.cpp:86-140``).
    """
    n, l = msa.shape
    x = jax.nn.one_hot(msa, q, dtype=weights.dtype).reshape(n, l * q)
    meff = jnp.sum(weights)
    xw = x * weights[:, None]
    f = jax.lax.dot_general(
        xw,
        x,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=weights.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return f / meff


def pair_index(i, j, l: int):
    """Closed-form index of pair ``(i, j)``, ``i < j``, in row-major pair order.

    ``P(i,j) = L(L-1)/2 - (L-i)(L-i-1)/2 + j - i - 1``
    (reference: ``pydca/meanfield_dca/msa_numerics.py:220``).
    """
    return (l * (l - 1)) // 2 - ((l - i) * (l - i - 1)) // 2 + j - i - 1


def pair_index_matrix(l: int) -> np.ndarray:
    """(L, L) int32 matrix M with M[i, j] = pair_index(min,max) (diag = 0)."""
    ii, jj = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
    lo, hi = np.minimum(ii, jj), np.maximum(ii, jj)
    m = (l * (l - 1)) // 2 - ((l - lo) * (l - lo - 1)) // 2 + hi - lo - 1
    np.fill_diagonal(m, 0)
    return m.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("q", "include_gap"))
def pair_site_freqs(
    msa: jax.Array, weights: jax.Array, q: int, *, include_gap: bool = False
) -> jax.Array:
    """Pair-site frequencies ``fij`` of shape ``(P, q', q')`` in pair order
    (0,1), (0,2), ..., (L-2,L-1); ``q' = q-1`` (gap excluded, the reference's
    mfDCA convention ``msa_numerics.py:182-229``) or ``q`` with
    ``include_gap=True`` (the C++ plmDCA convention ``plmdca_numerics.cpp:86-140``).
    """
    n, l = msa.shape
    f = weighted_gram(msa, weights, q).reshape(l, q, l, q)
    qe = q if include_gap else q - 1
    iu, ju = np.triu_indices(l, k=1)
    return f[:, :qe, :, :qe].transpose(0, 2, 1, 3)[iu, ju]


# ---------------------------------------------------------------- pseudocounts
def regularize_fi(fi: jax.Array, q: int, pseudocount: float) -> jax.Array:
    """``f <- theta/q + (1-theta) f``  (``msa_numerics.py:92-125``)."""
    return pseudocount / q + (1.0 - pseudocount) * fi


def regularize_fij(fij: jax.Array, q: int, pseudocount: float) -> jax.Array:
    """``f <- theta/q^2 + (1-theta) f``  (``msa_numerics.py:231-267``)."""
    return pseudocount / (q * q) + (1.0 - pseudocount) * fij


# ------------------------------------------------------------ correlation matrix
@functools.partial(jax.jit, static_argnames=("l", "q"))
def corr_mat_from_gram(
    gram: jax.Array, fi_reg: jax.Array, pseudocount: float, l: int, q: int
) -> jax.Array:
    """Mean-field correlation matrix ``C`` of shape ``(L*(q-1), L*(q-1))``.

    Off-diagonal blocks: ``C[(i,a),(j,b)] = fij_reg(i,j,a,b) - fi_reg(i,a) fi_reg(j,b)``;
    diagonal blocks: ``fi_reg(i,a) (delta_ab - fi_reg(i,b))``
    (reference: ``pydca/meanfield_dca/msa_numerics.py:270-318``).

    ``gram`` is the raw (unregularized) gram matrix from :func:`weighted_gram`;
    the pseudocount regularization of the pair frequencies is applied here.
    """
    qm1 = q - 1
    # Drop the gap rows, then (gram is symmetric) transpose and drop the gap
    # columns the same way.  Deliberately 2-D/3-D with large trailing dims,
    # so no layout pads a short trailing q-1 axis of a 4-D intermediate.
    g = gram.reshape(l, q, l * q)[:, :qm1, :].reshape(l * qm1, l * q)
    g = g.T.reshape(l, q, l * qm1)[:, :qm1, :].reshape(l * qm1, l * qm1)
    creg = pseudocount / (q * q) + (1.0 - pseudocount) * g
    fr = fi_reg[:, :qm1].reshape(-1)  # (L*(q-1),)
    sites = jnp.arange(l * qm1) // qm1
    blockdiag = sites[:, None] == sites[None, :]
    # Off-diagonal blocks: creg - fr fr'; diagonal blocks fi (delta - fi)
    # fold into: zero creg on the block diagonal, add diag(fr), subtract
    # the global rank-1 term.
    return (
        jnp.where(blockdiag, jnp.zeros((), gram.dtype), creg)
        + jnp.diag(fr)
        - fr[:, None] * fr[None, :]
    )
