"""Family-batched DCA: run many MSAs through one vmapped device program.

The reference processes one MSA per process invocation; on an accelerator
the natural way to amortize compilation and fill the device when families are
small is to pad a set of alignments of the same biomolecule to a common
``(F, Nmax, Lmax)`` block and ``vmap`` the whole pipeline over the family
axis (the "batched multi-family run" scaling axis, SURVEY.md section 2b).

Padding conventions:

- pad *sequences* are rows of the pad token ``q`` — ``jax.nn.one_hot``
  maps out-of-range indices to all-zero rows, so padded rows contribute
  nothing to identity counts, frequency sums, or pseudolikelihoods, and
  their sequence weight is forced to zero;
- pad *sites* are masked out of the pseudolikelihood per-site sum and
  excluded from scoring; their fields/couplings start at zero and only the
  L2 regularizer touches them, so they stay exactly zero.

Per-family quantities that depend on the true length (identity threshold
``seqid * L_f``, regularization ``0.2 (L_f - 1)``, APC site means) use the
unpadded lengths.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import score as score_mod
from . import stats
from .io.fasta import MSA
from .ops.lbfgs import lbfgs_init, lbfgs_steps

__all__ = [
    "FamilyBatch",
    "family_sequence_weights",
    "family_plm_fit",
    "family_plm_scores",
    "family_meanfield_scores",
    "bucket_families",
    "padded_flop_stats",
    "family_plm_fit_bucketed",
]


class FamilyBatch:
    """A set of same-biomolecule MSAs padded to a common (F, Nmax, Lmax).

    ``pad_to=(nmax, lmax)`` pads to the given bounds instead of the batch
    maxima — bucketed runs use canonical power-of-two bounds so every
    bucket of similar families reuses one compiled program shape.
    """

    def __init__(self, msas: Sequence[MSA], pad_to: Optional[Tuple[int, int]] = None):
        if not msas:
            raise ValueError("empty family batch")
        qs = {m.q for m in msas}
        if len(qs) != 1:
            raise ValueError("all families must share one biomolecule/alphabet")
        self.msas: List[MSA] = list(msas)
        self.q: int = qs.pop()
        self.num_families = len(msas)
        self.lengths = np.array([m.seqs_len for m in msas], np.int32)
        self.nseqs = np.array([m.num_seqs for m in msas], np.int32)
        lmax = int(self.lengths.max())
        nmax = int(self.nseqs.max())
        if pad_to is not None:
            if pad_to[0] < nmax or pad_to[1] < lmax:
                raise ValueError(
                    f"pad_to {pad_to} smaller than batch maxima ({nmax}, {lmax})"
                )
            nmax, lmax = int(pad_to[0]), int(pad_to[1])
        data = np.full((len(msas), nmax, lmax), self.q, np.int32)  # pad token q
        for f, m in enumerate(msas):
            data[f, : m.num_seqs, : m.seqs_len] = m.data
        self.data = data
        self.seq_mask = (
            np.arange(nmax)[None, :] < self.nseqs[:, None]
        )  # (F, Nmax)
        self.site_mask = (
            np.arange(lmax)[None, :] < self.lengths[:, None]
        )  # (F, Lmax)

    @property
    def lmax(self) -> int:
        return self.data.shape[2]

    @property
    def nmax(self) -> int:
        return self.data.shape[1]


@functools.partial(jax.jit, static_argnames=("q", "block"))
def _family_weights_impl(data, thr, seq_mask, q: int, block: int = 2048):
    """Per-family reweighting with the identity-count matmul *blocked* over
    row tiles, like :func:`pydca_tpu.stats._sequence_weights_impl`: only a
    ``(block, Nmax)`` tile of the similarity matrix is ever live (per vmap
    lane), so deep family batches never materialize (Nmax, Nmax) buffers.

    Padded rows one-hot to all-zeros (pad token = q), so their identity
    count against anything is 0 < thr and they never count as neighbors.
    """

    def one_family(msa_f, thr_f, mask_f):
        n = msa_f.shape[0]
        x = jax.nn.one_hot(msa_f, q, dtype=jnp.int8).reshape(n, -1)
        nblocks = -(-n // block)
        npad = nblocks * block
        xp = jnp.pad(x, ((0, npad - n), (0, 0)))

        def body(carry, xi):
            counts = jax.lax.dot_general(
                xi, x, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )  # (block, Nmax) int32 — exact
            sims = jnp.sum(
                (counts.astype(jnp.float32) > thr_f).astype(jnp.int32), axis=1
            )
            return carry, sims

        _, sims = jax.lax.scan(body, None, xp.reshape(nblocks, block, -1))
        sims = sims.reshape(npad)[:n].astype(jnp.float32)
        return jnp.where(mask_f, 1.0 / jnp.maximum(sims, 1.0), 0.0)

    return jax.vmap(one_family)(data, thr, seq_mask)


def family_sequence_weights(batch: FamilyBatch, seqid: float = 0.8) -> jax.Array:
    """(F, Nmax) reweighting, zero on padded rows; threshold ``seqid * L_f``."""
    thr = jnp.asarray(seqid * batch.lengths, jnp.float32)
    return _family_weights_impl(
        jnp.asarray(batch.data), thr, jnp.asarray(batch.seq_mask), batch.q
    )


# ----------------------------------------------------------- masked plm loss
@functools.partial(jax.jit, static_argnames=("l", "q"))
def _family_plm_loss(theta, msa, weights, pidx, site_mask, lambda_h, lambda_j,
                     l: int, q: int):
    """Masked pseudolikelihood for one (padded) family; see plm.plm_loss."""
    from .plm import _expand_full

    del pidx  # index map derived statically from l (plm._expand_full)
    dtype = theta.dtype
    h = theta[: l * q].reshape(l, q)
    jfull = _expand_full(theta[l * q :], l, q)
    # (N, q, L) logits layout: L contiguous (see plm._plm_loss_prepped)
    w2 = jfull.transpose(1, 3, 2, 0).reshape(l * q, q * l)
    x = jax.nn.one_hot(msa, q, dtype=dtype).reshape(-1, l * q)
    logits = (
        jax.lax.dot_general(
            x, w2, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=dtype,
        ).reshape(-1, q, l)
        + h.T[None]
    )
    lse = jax.scipy.special.logsumexp(logits, axis=1)  # (N, L)
    maskq = msa[:, None, :] == jnp.arange(q, dtype=msa.dtype)[None, :, None]
    picked = jnp.sum(jnp.where(maskq, logits, 0), axis=1)
    per_site = (lse - picked) * site_mask[None, :]
    nll = jnp.sum(weights[:, None] * per_site)
    reg = lambda_h * jnp.sum(h * h) + lambda_j * jnp.sum(theta[l * q :] ** 2)
    return nll + reg


def family_plm_fit(
    batch: FamilyBatch,
    *,
    seqid: float = 0.8,
    lambda_h: Optional[np.ndarray] = None,
    lambda_j: Optional[np.ndarray] = None,
    max_iterations: int = 100,
    m: int = 5,
    weights: Optional[jax.Array] = None,
):
    """Fit all families at once; returns ``(thetas (F, D), states)``.

    Per-family regularization defaults to the reference's ``0.2 (L_f - 1)``
    (``pydca/plmdca/plmdca.py:64-68``).  One compiled program: vmapped
    init + vmapped L-BFGS (the batched ``while_loop`` runs until the slowest
    family finishes; finished families' states are carried unchanged).
    """
    l, q = batch.lmax, batch.q
    if weights is None:
        weights = family_sequence_weights(batch, seqid)
    lam_h = (
        jnp.asarray(0.2 * (batch.lengths - 1), jnp.float32)
        if lambda_h is None
        else jnp.asarray(lambda_h, jnp.float32)
    )
    lam_j = (
        jnp.asarray(0.2 * (batch.lengths - 1), jnp.float32)
        if lambda_j is None
        else jnp.asarray(lambda_j, jnp.float32)
    )
    states = _family_fit_impl(
        jnp.asarray(batch.data),
        weights,
        jnp.asarray(stats.pair_index_matrix(l)),
        jnp.asarray(batch.site_mask, jnp.float32),
        lam_h,
        lam_j,
        l,
        q,
        m,
        max_iterations,
    )
    return states.x, states


@functools.partial(
    jax.jit, static_argnames=("l", "q", "m", "max_iterations")
)
def _family_fit_impl(
    data, weights, pidx, site_mask, lam_h, lam_j, l: int, q: int, m: int,
    max_iterations: int,
):
    from .plm import init_params

    def one_family(msa_f, w_f, mask_f, lh_f, lj_f):
        fun = lambda t: jax.value_and_grad(_family_plm_loss)(
            t, msa_f, w_f, pidx, mask_f, lh_f, lj_f, l, q
        )
        theta0 = init_params(msa_f, w_f, l, q)
        state = lbfgs_init(fun, theta0, m=m)
        return lbfgs_steps(fun, state, max_iterations)

    return jax.vmap(one_family)(data, weights, site_mask, lam_h, lam_j)


# ------------------------------------------------------------- score extraction
def _family_pair_select(l_f: int, lmax: int) -> np.ndarray:
    """Indices into the Lmax pair order for the pairs within the first l_f sites."""
    iu, ju = np.triu_indices(l_f, k=1)
    return np.asarray(stats.pair_index(iu, ju, lmax), np.int64)


def family_plm_scores(
    batch: FamilyBatch, thetas: jax.Array, *, apc: bool = True
):
    """Per-family sorted FN(-APC) score lists from batched parameters."""
    l, q = batch.lmax, batch.q
    p = l * (l - 1) // 2
    blocks_all = np.asarray(thetas)[:, l * q :].reshape(
        batch.num_families, p, q, q
    )[:, :, : q - 1, : q - 1]
    out = []
    for f, l_f in enumerate(batch.lengths):
        l_f = int(l_f)
        sel = _family_pair_select(l_f, l)
        fn = np.asarray(
            score_mod.frobenius_norms(jnp.asarray(blocks_all[f][sel]))
        )
        if apc:
            fn = np.asarray(score_mod.apc(jnp.asarray(fn), l_f))
        out.append(score_mod.sorted_scores(fn, l_f))
    return out


def family_meanfield_scores(
    batch: FamilyBatch,
    *,
    seqid: float = 0.8,
    pseudocount: float = 0.5,
    apc: bool = True,
):
    """Mean-field FN(-APC) scores for every family via one vmapped program.

    Correlation rows/columns of padded sites are replaced by identity before
    the inverse, so the solve is block-diagonal and pad couplings are exactly
    zero (then dropped at extraction).
    """
    weights = family_sequence_weights(batch, seqid)
    couplings = _family_mf_couplings(
        jnp.asarray(batch.data),
        weights,
        jnp.asarray(batch.site_mask, jnp.float32),
        jnp.float32(pseudocount),
        batch.lmax,
        batch.q,
    )
    out = []
    qm1 = batch.q - 1
    lmax = batch.lmax
    cnp = np.asarray(couplings).reshape(
        batch.num_families, lmax, qm1, lmax, qm1
    )
    for f, l_f in enumerate(batch.lengths):
        l_f = int(l_f)
        iu, ju = np.triu_indices(l_f, k=1)
        blocks = cnp[f][iu, :, ju, :]  # (P_f, q-1, q-1)
        fn = np.asarray(score_mod.frobenius_norms(jnp.asarray(blocks)))
        if apc:
            fn = np.asarray(score_mod.apc(jnp.asarray(fn), l_f))
        out.append(score_mod.sorted_scores(fn, l_f))
    return out


@functools.partial(jax.jit, static_argnames=("l", "q"))
def _family_mf_couplings(data, weights, site_mask, pseudocount, l: int, q: int):
    def one_family(msa_f, w_f, mask_f):
        gram = stats.weighted_gram(msa_f, w_f, q)
        fi = jnp.diagonal(gram).reshape(l, q)
        fi_reg = stats.regularize_fi(fi, q, pseudocount)
        corr = stats.corr_mat_from_gram(gram, fi_reg, pseudocount, l, q)
        # identity rows/cols on padded sites -> block-diagonal inverse
        mvec = jnp.repeat(mask_f, q - 1)
        m2 = mvec[:, None] * mvec[None, :]
        eye = jnp.eye(l * (q - 1), dtype=corr.dtype)
        corr = corr * m2 + eye * (1.0 - m2)
        from .meanfield import _spd_inverse

        return -_spd_inverse(corr)

    return jax.vmap(one_family)(data, weights, site_mask)


# ------------------------------------------------------------- bucketed batch
def _pow2_at_least(x: int, floor: int) -> int:
    n = max(int(x), floor)
    return 1 << (n - 1).bit_length()


def bucket_families(
    msas: Sequence[MSA], *, min_n: int = 64, min_l: int = 16
):
    """Group family indices into (N, L) power-of-two buckets.

    A single ``(F, Nmax, Lmax)`` block burns device time on pad rows/sites
    whenever the families are heterogeneous, and the lock-step vmapped
    ``while_loop`` runs every family until the slowest converges
    (VERDICT r3 item 8).  Bucketing by rounded-up (N, L) bounds both
    wastes: padding is at most ~4x the family's own size (2x per axis),
    and lock-step applies within a bucket only.  Power-of-two bounds keep
    the compiled program shapes canonical across runs.

    Returns ``{(n_bound, l_bound): [original indices]}``.
    """
    groups = {}
    for idx, m in enumerate(msas):
        key = (
            _pow2_at_least(m.num_seqs, min_n),
            _pow2_at_least(m.seqs_len, min_l),
        )
        groups.setdefault(key, []).append(idx)
    return groups


def padded_flop_stats(msas: Sequence[MSA], groups=None) -> dict:
    """Padded-vs-useful FLOP accounting for the plm data term.

    Per family the dominant cost is the logits matmul,
    ``N * (L*q)^2`` model FLOPs per objective evaluation (times a
    constant).  Reports the single-block padding waste and the bucketed
    waste so the bucketing payoff is measurable.
    """
    q = msas[0].q
    cost = lambda n, l: float(n) * (float(l) * q) ** 2
    useful = sum(cost(m.num_seqs, m.seqs_len) for m in msas)
    nmax = max(m.num_seqs for m in msas)
    lmax = max(m.seqs_len for m in msas)
    single = len(msas) * cost(nmax, lmax)
    if groups is None:
        groups = bucket_families(msas)
    bucketed = 0.0
    for idxs in groups.values():
        nb = max(msas[i].num_seqs for i in idxs)
        lb = max(msas[i].seqs_len for i in idxs)
        bucketed += len(idxs) * cost(nb, lb)
    return {
        "useful_flops": useful,
        "single_block_flops": single,
        "bucketed_flops": bucketed,
        "single_block_waste": single / useful,
        "bucketed_waste": bucketed / useful,
    }


def family_plm_fit_bucketed(
    msas: Sequence[MSA],
    *,
    seqid: float = 0.8,
    max_iterations: int = 100,
    apc: bool = True,
    min_n: int = 64,
    min_l: int = 16,
):
    """Fit many heterogeneous families, one compiled program per bucket.

    Returns ``(scores_per_family, stats)`` with scores in the input order
    (each a sorted [(i, j), score] list, FN-APC by default) and the
    :func:`padded_flop_stats` dict extended with the bucket count.
    """
    groups = bucket_families(msas, min_n=min_n, min_l=min_l)
    scores: List = [None] * len(msas)
    for key in sorted(groups):
        idxs = groups[key]
        batch = FamilyBatch([msas[i] for i in idxs], pad_to=key)
        thetas, _ = family_plm_fit(
            batch, seqid=seqid, max_iterations=max_iterations
        )
        for i, sc in zip(idxs, family_plm_scores(batch, thetas, apc=apc)):
            scores[i] = sc
    stats_d = padded_flop_stats(msas, groups)
    stats_d["num_buckets"] = len(groups)
    return scores, stats_d
