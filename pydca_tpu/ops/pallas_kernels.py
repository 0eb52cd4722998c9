"""Pallas GPU kernel for the all-pairs identity count behind reweighting.

:func:`identity_counts` is the O(N^2 L) sequence-identity count of the
reference (``pydca/plmdca/plmdca_numerics.cpp:611-671``): for every row i,
``#{j : identity(i, j) > thr}``.  It reads only the int8 (N, L) codes,
builds each state's one-hot plane in registers, runs one tensor-core dot
per plane, and fuses the threshold compare, the neighbour mask and the row
sum into the epilogue — neither the (N, L*q) one-hot nor any (N, N) count
tile ever reaches device memory.

It is written for Pallas' Triton route (``backend="triton"``):

- one program owns ``block_i`` rows and walks its share of the column
  blocks in an in-kernel ``fori_loop``; the row sums stay in registers,
  so no sum crosses programs and no atomics are needed;
- when there are too few row blocks to fill the card, the column blocks
  are split over a second grid axis and the partial row sums are added
  by XLA afterwards (one small (splits, N) int32 array);
- products are 0/1 and counts are at most L, so the int8 x int8 -> int32
  dots are exact (bf16 planes, also exact, measured slower on an H100).

:mod:`pydca_tpu.stats` dispatches to it on the GPU and to the blocked XLA
scan on the CPU.  ``interpret=True`` runs the same kernel on the CPU
(tests).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = ["identity_counts", "IdentityTiles"]


class IdentityTiles(NamedTuple):
    """Tiling of :func:`identity_counts` (``block_k`` sites per dot).

    The defaults won the sweep of ``scripts/tune_defaults.py weights`` on
    an H100 at every timed shape (PERF.md).
    """

    block_i: int = 128
    block_j: int = 128
    block_k: int = 128


# Triton launch parameters; 8 warps and 3 stages won the same sweep (4
# stages tied within 1%).
_NUM_WARPS = 8
_NUM_STAGES = 3

# Enough programs to keep every SM of the card busy for several waves; fewer
# row blocks than this split the column blocks over a second grid axis.
_MIN_PROGRAMS = 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_at_least(x: int, lo: int) -> int:
    return max(lo, 1 << max(0, int(x) - 1).bit_length())


def _kernel(ci_ref, c_ref, v_ref, out_ref, *, q, thr, block_j, block_k,
            nj_split):
    bi, lpad = ci_ref.shape
    split = pl.program_id(1)

    def body_j(jj, sims):
        j0 = pl.multiple_of((split * nj_split + jj) * block_j, block_j)

        def body_k(k, acc):
            k0 = pl.multiple_of(k * block_k, block_k)
            ci = ci_ref[:, pl.ds(k0, block_k)]
            cj = c_ref[pl.ds(j0, block_j), pl.ds(k0, block_k)]
            # pad code -1 matches no state: padded sites and rows count 0
            for s in range(q):
                acc += pl.dot(
                    (ci == s).astype(jnp.int8), (cj == s).astype(jnp.int8),
                    trans_b=True,
                )
            return acc

        acc = jax.lax.fori_loop(
            0, lpad // block_k, body_k, jnp.zeros((bi, block_j), jnp.int32)
        )
        v = v_ref[pl.ds(j0, block_j)]
        hit = (acc.astype(jnp.float32) > thr) & (v[None, :] != 0)
        return sims + jnp.sum(hit, axis=1, dtype=jnp.int32)

    out_ref[...] = jax.lax.fori_loop(
        0, nj_split, body_j, jnp.zeros((bi,), jnp.int32)
    )


@functools.partial(
    jax.jit, static_argnames=("thr", "q", "tiles", "interpret")
)
def identity_counts(
    codes: jax.Array,
    thr: float,
    q: int,
    valid: jax.Array | None = None,
    *,
    cols: jax.Array | None = None,
    tiles: IdentityTiles = IdentityTiles(),
    interpret: bool = False,
) -> jax.Array:
    """#{j : identity(i, j) > thr} for every row i, from int codes.

    ``codes``: (N, L) integer alignment with states in [0, q).  ``thr`` is
    compared in float32, exactly as the blocked XLA scan compares it.
    ``cols``: the (M, L) rows to count against (default ``codes``; a
    data-parallel caller passes its local rows as ``codes`` and the whole
    alignment as ``cols``).  ``valid``: optional (M,) bool mask over
    ``cols`` — rows with ``valid = False`` (shard padding) are excluded
    from every neighbour count.  Returns (N,) int32.
    """
    cols = codes if cols is None else cols
    n, l = codes.shape
    m = cols.shape[0]
    bi, bj, bk = tiles.block_i, tiles.block_j, tiles.block_k
    # tiles never exceed the (power-of-two) padded problem
    bk = min(bk, _pow2_at_least(l, 32))
    bi = min(bi, _pow2_at_least(n, 16))
    bj = min(bj, _pow2_at_least(m, 16))
    lpad = _round_up(l, bk)
    npad, mpad = _round_up(n, bi), _round_up(m, bj)

    def pad(c, rows):
        return jnp.pad(
            c.astype(jnp.int8), ((0, rows - c.shape[0]), (0, lpad - l)),
            constant_values=-1,
        )

    v = jnp.ones((m,), jnp.int32) if valid is None else valid.astype(jnp.int32)
    v = jnp.pad(v, (0, mpad - m))
    ni, nj = npad // bi, mpad // bj
    splits = 1
    while ni * splits < _MIN_PROGRAMS and nj % (2 * splits) == 0:
        splits *= 2
    kernel = functools.partial(
        _kernel, q=q, thr=float(np.float32(thr)), block_j=bj, block_k=bk,
        nj_split=nj // splits,
    )
    parts = pl.pallas_call(
        kernel,
        grid=(ni, splits),
        in_specs=[
            pl.BlockSpec((bi, lpad), lambda i, s: (i, 0)),
            pl.BlockSpec((mpad, lpad), lambda i, s: (0, 0)),
            pl.BlockSpec((mpad,), lambda i, s: (0,)),
        ],
        out_specs=pl.BlockSpec((None, bi), lambda i, s: (s, i)),
        out_shape=jax.ShapeDtypeStruct((splits, npad), jnp.int32),
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES
        ),
        backend="triton",
        interpret=interpret,
        name="identity_counts",
    )(pad(codes, npad), pad(cols, mpad), v)
    return jnp.sum(parts, axis=0)[:n]
