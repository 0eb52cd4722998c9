"""Matmul-rich dense linear algebra for the mean-field solve.

The mean-field engine needs the full inverse of the SPD correlation matrix
``C`` (couplings = -C^{-1}; reference inverts with LU,
``pydca/meanfield_dca/msa_numerics.py:321-342``).  At protein scale
(L=1000 -> C is 20000 x 20000) XLA's triangular solve with a wide
right-hand side is both slow (sequential substitution structure) and
memory-hungry (O(D * rhs) staged temporaries).  Instead we compute

    C^{-1} = L^{-T} L^{-1} = W^T W,   W = L^{-1},

where the triangular inverse W is built by divide and conquer:

    [A 0; B C]^{-1} = [A^{-1} 0; -C^{-1} B A^{-1}, C^{-1}]

so all O(n^3) work lands in large matmuls; only the
``block``-sized base cases use a substitution solve.  The final SYRK
``W^T W`` is a single big matmul.  Total ~4/3 n^3 FLOPs of matmul versus
~2 n^3 of substitution-structured triangular solves.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["tri_inv_lower", "spd_inverse", "cholesky_blocked", "syrk_sharded"]

# Base-case size of the divide-and-conquer triangular inverse.  Swept at
# D=20000 on an H100 (scripts/tune_defaults.py linalg; PERF.md): 1024, 2048
# and 4096 run within 3% of each other, 2048 is kept.  The chain runs at
# DEFAULT precision (TF32 on the GPU), which keeps mean-field FN-APC at
# Spearman 0.999998 against a float64 oracle at the PF02826 shape.
_BASE_BLOCK = 2048


def _model_axis_size(n: int):
    """Size of an ambient 'model' mesh axis that divides ``n``, else None.

    Detects the mesh installed by ``jax.set_mesh`` (works under jit
    tracing); used to decide whether the sharded code paths below apply.
    """
    try:
        am = jax.sharding.get_abstract_mesh()
        if am is None or "model" not in (am.axis_names or ()):
            return None
        size = int(am.shape["model"])
    except Exception:  # pragma: no cover - old-JAX drift
        return None
    if size <= 1 or n % size != 0:
        return None
    return size


def _constrain_rows(x: jax.Array) -> jax.Array:
    """Row-shard ``x`` over an ambient 'model' axis when one is present.

    A no-op otherwise, so the linalg kernels stay mesh-agnostic: the same
    code runs single-chip and, under ``jax.set_mesh``, keeps every O(D^2)
    intermediate distributed instead of letting GSPMD's propagation
    replicate slices/concats (measured at D=40k on an 8-device mesh:
    5.2 -> 3.6 GiB per-device peak for the triangular inverse).
    """
    if _model_axis_size(x.shape[0]) is None:
        return x
    from jax.sharding import PartitionSpec as P

    return jax.lax.with_sharding_constraint(
        x, P("model", *([None] * (x.ndim - 1)))
    )


def syrk_sharded(w: jax.Array, block: int = 2048) -> jax.Array:
    """``W^T @ W`` for square ``W``, memory-lean under a 'model' mesh axis.

    Plain ``w.T @ w`` contracts over the row-sharded axis, and GSPMD
    materializes a full (n, n) partial product PER DEVICE before the
    all-reduce — 5.96 GiB each at D=40k, the dominant replicated buffer of
    the sharded mean-field solve.  Under ``shard_map`` each device instead
    computes one (n, block) partial at a time inside a sequential
    ``fori_loop`` and ``psum_scatter``s it straight into its own row slice
    of the output: per-device temp measured at D=40k drops 11.9 -> 0.34
    GiB, with identical FLOPs.  Falls back to the plain matmul with no
    mesh (or when the mesh does not divide n).
    """
    n = w.shape[0]
    nshard = _model_axis_size(n)
    if nshard is None:
        return w.T @ w
    blk = min(block, n)
    nsteps = -(-n // blk)
    mesh = jax.sharding.get_abstract_mesh()
    from jax.sharding import PartitionSpec as P

    def f(wl):
        nloc = wl.shape[0]

        def body(i, out):
            # clamp the last block: the overlap recomputes identical values
            start = jnp.minimum(i * blk, n - blk)
            wslice = jax.lax.dynamic_slice(wl, (0, start), (nloc, blk))
            part = jax.lax.dot_general(
                wl, wslice, dimension_numbers=(((0,), (0,)), ((), ()))
            )  # (n, blk) local partial
            sc = jax.lax.psum_scatter(
                part, "model", scatter_dimension=0, tiled=True
            )
            return jax.lax.dynamic_update_slice(out, sc, (0, start))

        init = jax.lax.pcast(
            jnp.zeros((nloc, n), wl.dtype), ("model",), to="varying"
        )
        return jax.lax.fori_loop(0, nsteps, body, init)

    return jax.shard_map(
        f, mesh=mesh, in_specs=P("model", None), out_specs=P("model", None)
    )(w)


def cholesky_blocked(c: jax.Array, block: int = 2048) -> jax.Array:
    """Lower Cholesky factor with the O(n^3) work in full-height GEMMs.

    Left-looking column-slab factorization: for each ``block``-wide panel
    ``k`` the update ``S = C[:, k:k+b] - L_prev @ L_prev[k:k+b, :].T`` and
    the scaling ``S @ inv(L_kk).T`` are *full-height* ``(n, ...)`` matmuls,
    so under GSPMD a ``P('model', None)`` row sharding of ``C`` carries
    through every heavy op and across every device — only the tiny
    ``(b, b)`` panel factorization is replicated.  XLA's own ``cholesky``
    has no distributed kernel, which forces the whole factor to be
    replicated per chip; at protein L=2000 (D=40k) that is a 6.4 GiB
    buffer on every device, while here each device holds
    ``1/n_model`` of every slab (SURVEY section 5(c): "sharded dense
    solve"; replaces replicated ``jnp.linalg.cholesky`` for large D).

    The full-height formulation deliberately trades FLOPs for
    shardability: rows above the diagonal compute values that are masked
    to zero (~3x the minimal Cholesky FLOP count, all of it matmul),
    in exchange for *zero* resharding — no slicing of the sharded row
    axis ever happens.  With >=4-way model sharding the wall-clock still
    beats the replicated single-chip factorization, and the memory win is
    the point.

    Matches ``jnp.linalg.cholesky`` to accumulation tolerance (tested).
    """
    n = c.shape[0]
    if n <= block:
        return jnp.linalg.cholesky(c)
    rows = jnp.arange(n)[:, None]
    cols = []
    for k in range(0, n, block):
        b = min(block, n - k)
        s = c[:, k : k + b]  # (n, b) — row sharding preserved
        if cols:
            lprev = _constrain_rows(jnp.concatenate(cols, axis=1))  # (n, done)
            s = s - lprev @ lprev[k : k + b, :].T
        s = _constrain_rows(s)
        panel = jnp.linalg.cholesky(s[k : k + b, :])  # (b, b), replicated
        linv_t = tri_inv_lower(panel).T
        # rows k:k+b of s are panel @ panel.T, so s @ linv_t restores the
        # panel itself there; rows below give L21; rows above are masked.
        col = jnp.where(rows >= k, s @ linv_t, jnp.zeros((), c.dtype))
        cols.append(_constrain_rows(col))
    return _constrain_rows(jnp.concatenate(cols, axis=1))


def tri_inv_lower(m: jax.Array, block: int = _BASE_BLOCK) -> jax.Array:
    """Inverse of a lower-triangular matrix via matmul-rich divide & conquer.

    Under an ambient 'model' mesh axis every recursion level's operands and
    results are re-constrained to row sharding (:func:`_constrain_rows`),
    which keeps the big halves/concats distributed instead of replicated.
    """
    n = m.shape[0]
    # n < 256 cannot produce a valid 128-aligned split (k would leave a
    # sub-128 or negative remainder for custom block < 256): solve directly.
    if n <= block or n < 256:
        return jax.scipy.linalg.solve_triangular(
            m, jnp.eye(n, dtype=m.dtype), lower=True
        )
    # Split at a 128-aligned midpoint so every matmul operand tiles cleanly.
    k = min(max(((n // 2) + 127) // 128 * 128, 128), n - 128)
    a_inv = _constrain_rows(tri_inv_lower(m[:k, :k], block))
    c_inv = _constrain_rows(tri_inv_lower(m[k:, k:], block))
    b21 = _constrain_rows(-c_inv @ _constrain_rows(m[k:, :k] @ a_inv))
    top = jnp.concatenate([a_inv, jnp.zeros((k, n - k), m.dtype)], axis=1)
    bot = jnp.concatenate([b21, c_inv], axis=1)
    return _constrain_rows(jnp.concatenate([top, bot], axis=0))


@functools.partial(jax.jit, static_argnames=("block", "chol_block"))
def spd_inverse(
    c: jax.Array, block: int = _BASE_BLOCK, chol_block: int | None = None
) -> jax.Array:
    """Inverse of a symmetric positive-definite matrix, ``C^{-1} = W^T W``.

    Cholesky on the full matrix (XLA's blocked kernel, or — when
    ``chol_block`` is set — the GEMM-rich :func:`cholesky_blocked` whose
    heavy ops shard over a row-sharded operand), triangular inverse by
    divide & conquer, then one SYRK.  Peak temporary memory is ~3 matrices
    (factor, W, result), versus the O(D * D) staged solve temporaries of a
    wide ``cho_solve``.
    """
    if chol_block is not None and c.shape[0] > chol_block:
        chol = cholesky_blocked(c, chol_block)
    else:
        chol = jnp.linalg.cholesky(c)
    w = tri_inv_lower(chol, block)
    # W^T W: under a 'model' mesh this is the memory-critical op — see
    # syrk_sharded (plain w.T @ w replicates an (n, n) partial per device).
    inv = syrk_sharded(w)
    # Symmetrize to remove accumulation-order asymmetry.
    return 0.5 * (inv + inv.T)
