"""Mean-field DCA engine.

Pipeline (reference: ``pydca/meanfield_dca/meanfield_dca.py``):
sequence weights -> regularized single/pair frequencies -> correlation matrix
``C`` -> couplings ``-C^{-1}`` -> FN / DI scores (+ APC, + optional refseq
backmapping).

Redesigned around matmuls: the counting layer is one weighted gram matmul
(:mod:`pydca_tpu.stats`), the correlation matrix is an elementwise transform of
it, the dense inverse runs as Cholesky plus matmuls (``C`` is symmetric
positive definite for any pseudocount > 0), and FN/DI scoring is vectorized
over all L(L-1)/2 pairs at once (:mod:`pydca_tpu.score`).
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import score as score_mod
from . import stats
from .ops import linalg
from .io.fasta import MSA, read_msa
from .profiling import StageTimers

logger = logging.getLogger(__name__)

__all__ = ["MeanFieldDCA", "MeanFieldDCAException"]


class MeanFieldDCAException(Exception):
    """Errors specific to the mean-field DCA engine."""


def _as_msa(msa, biomolecule: str) -> MSA:
    if isinstance(msa, MSA):
        return msa
    if isinstance(msa, str):
        return read_msa(msa, biomolecule)
    if isinstance(msa, (np.ndarray, jnp.ndarray)):
        from .alphabets import get_alphabet

        return MSA(data=np.asarray(msa, dtype=np.int8), alphabet=get_alphabet(biomolecule))
    # Anything iterable of (id, sequence) pairs, sequence strings, or
    # SeqRecord-like objects — covers Bio.Align.MultipleSeqAlignment input
    # without a Biopython dependency (reference accepts one,
    # ``meanfield_dca.py:97-106``).
    try:
        from .alphabets import get_alphabet

        alphabet = get_alphabet(biomolecule)
        seqs = []
        ids = []
        for item in msa:
            if isinstance(item, str):
                ids.append(f"seq{len(seqs)}")
                seqs.append(item.upper())
            elif hasattr(item, "id") and hasattr(item, "seq"):
                ids.append(str(item.id))
                seqs.append(str(item.seq).upper())
            else:
                sid, s = item
                ids.append(str(sid))
                seqs.append(str(s).upper())
        data = alphabet.encode_many(seqs)
        from .io.fasta import _dedup_encoded

        data, ids = _dedup_encoded(data, ids)
        return MSA(data=data, alphabet=alphabet, ids=ids)
    except Exception as exc:
        raise MeanFieldDCAException(f"cannot interpret MSA input: {exc}") from exc


@functools.partial(
    jax.jit, static_argnames=("l", "q", "seqid", "pseudocount", "dtype")
)
def _mf_fused_pipeline(msa, l: int, q: int, seqid: float, pseudocount: float, dtype):
    """The whole mfDCA FN pipeline as ONE device program.

    weights -> gram -> correlation matrix -> couplings (-C^{-1}) -> raw FN
    and FN-APC scores.  A cold CLI run compiles one program and crosses
    the host<->device boundary once, instead of paying per-program compile
    and dispatch latency for the six staged kernels (the staged methods remain for API parity and for
    explicit-frequency inputs).

    Returns ``(weights, couplings, fn_raw, fn_apc)``.
    """
    from . import score as _score

    w = stats.sequence_weights(msa, seqid, q, dtype=dtype)
    gram = stats.weighted_gram(msa, w, q)
    fi = jnp.diagonal(gram).reshape(l, q)
    fi_reg = stats.regularize_fi(fi, q, pseudocount)
    c = stats.corr_mat_from_gram(gram, fi_reg, pseudocount, l, q).astype(dtype)
    couplings = -linalg.spd_inverse(c)
    fn_raw = _score.frobenius_norms_from_matrix(couplings, l, q - 1)
    fn_apc = _score.apc(fn_raw, l)
    return w, couplings, fn_raw, fn_apc


def _resolve_mesh(mesh):
    """``None`` -> single device; ``"auto"`` -> a ('data','model') mesh over
    all visible devices when more than one is present; a Mesh passes
    through."""
    if mesh is None:
        return None
    if mesh == "auto":
        if jax.device_count() > 1:
            from .parallel.mesh import make_mesh

            return make_mesh()
        return None
    return mesh


class MeanFieldDCA:
    """Mean-field Direct Coupling Analysis.

    Parameters
    ----------
    msa : str | MSA | np.ndarray | list
        Path to a FASTA file, an :class:`~pydca_tpu.io.fasta.MSA`, an encoded
        ``(N, L)`` int array, or a list of sequences / (id, seq) pairs.
        (The reference accepts a file path or a Bio.Align object,
        ``meanfield_dca.py:97-106``.)
    biomolecule : str
        ``"protein"`` or ``"rna"``.
    pseudocount : float
        Relative pseudocount theta in [0, 1); default 0.5
        (``meanfield_dca.py:73``).
    seqid : float
        Sequence-identity threshold in (0, 1]; default 0.8
        (``meanfield_dca.py:74``).
    dtype : jnp.dtype
        Compute dtype.  float32 runs at device speed; float64 (CPU) reproduces
        the reference's numba float64 path bit-for-bit closer for parity tests.
    """

    def __init__(
        self,
        msa,
        biomolecule: str,
        pseudocount: float = 0.5,
        seqid: float = 0.8,
        *,
        dtype=jnp.float32,
        mesh=None,
    ):
        if not 0.0 <= pseudocount < 1.0:
            raise MeanFieldDCAException(
                f"pseudocount must be in [0, 1); got {pseudocount}"
            )
        if not 0.0 < seqid <= 1.0:
            raise MeanFieldDCAException(f"seqid must be in (0, 1]; got {seqid}")
        self.msa = _as_msa(msa, biomolecule)
        self.__pseudocount = float(pseudocount)
        self.__seqid = float(seqid)
        self.dtype = dtype
        self.__mesh = _resolve_mesh(mesh)
        # caches
        self.__weights: Optional[jax.Array] = None
        self.__gram: Optional[jax.Array] = None
        self.__couplings: Optional[jax.Array] = None
        self.__fn_raw: Optional[jax.Array] = None
        self.__fn_apc: Optional[jax.Array] = None
        self.__refseq_mapping_dict = None
        self.timers = StageTimers()

    # ------------------------------------------------------------- properties
    @property
    def alignment(self) -> np.ndarray:
        """MSA in integer form, 1-based with gap = q (reference convention,
        ``meanfield_dca.py:140-147``).  Internal storage is 0-based."""
        return np.asarray(self.msa.data, dtype=np.int64) + 1

    @property
    def biomolecule(self) -> str:
        return self.msa.alphabet.name

    @property
    def sequences_len(self) -> int:
        return self.msa.seqs_len

    @property
    def num_sequences(self) -> int:
        return self.msa.num_seqs

    @property
    def num_site_states(self) -> int:
        return self.msa.q

    @property
    def pseudocount(self) -> float:
        return self.__pseudocount

    @property
    def sequence_identity(self) -> float:
        return self.__seqid

    @property
    def effective_num_sequences(self) -> float:
        return float(jnp.sum(self.get_sequences_weight()))

    @property
    def sequences_weight(self) -> jax.Array:
        """Sequence weights (reference property ``meanfield_dca.py:186-193``)."""
        return self.get_sequences_weight()

    # ------------------------------------------------------------ statistics
    def compute_sequences_weight(self) -> jax.Array:
        """Recompute sequence weights (reference ``meanfield_dca.py:212-233``)."""
        self.__weights = None
        return self.get_sequences_weight()

    def get_sequences_weight(self) -> jax.Array:
        if self.__weights is None:
            with self.timers.stage("weights"):
                if self.__mesh is not None and self.dtype == jnp.float32:
                    # the CLI metadata header asks for Meff BEFORE the
                    # pipeline runs; with a mesh, compute the O(N^2 L)
                    # identity counts data-parallel rather than on one chip
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
                        dtype=self.dtype,
                    )
                jax.block_until_ready(self.__weights)
            self.timers.add_rate("weights", self.msa.num_seqs, "seqs")
        return self.__weights

    def _get_gram(self) -> jax.Array:
        if self.__gram is None:
            self.__gram = stats.weighted_gram(
                jnp.asarray(self.msa.data, jnp.int32),
                self.get_sequences_weight(),
                self.msa.q,
            )
        return self.__gram

    def get_single_site_freqs(self) -> jax.Array:
        """Raw weighted ``fi`` of shape (L, q)."""
        l, q = self.msa.seqs_len, self.msa.q
        return jnp.diagonal(self._get_gram()).reshape(l, q)

    def get_reg_single_site_freqs(self) -> jax.Array:
        return stats.regularize_fi(
            self.get_single_site_freqs(), self.msa.q, self.__pseudocount
        )

    def get_pair_site_freqs(self) -> jax.Array:
        """Raw ``fij`` of shape (P, q-1, q-1) (gap excluded, mf convention)."""
        l, q = self.msa.seqs_len, self.msa.q
        f4 = self._get_gram().reshape(l, q, l, q)[:, : q - 1, :, : q - 1]
        iu, ju = np.triu_indices(l, k=1)
        return f4.transpose(0, 2, 1, 3)[iu, ju]

    def get_reg_pair_site_freqs(self) -> jax.Array:
        return stats.regularize_fij(
            self.get_pair_site_freqs(), self.msa.q, self.__pseudocount
        )

    def construct_corr_mat(self, reg_fi=None, reg_fij=None) -> jax.Array:
        """Correlation matrix ``C`` of shape (L(q-1), L(q-1)).

        With no arguments this is a fused elementwise transform of the weighted
        gram matrix.  Passing ``reg_fi``/``reg_fij`` mirrors the reference
        signature (``meanfield_dca.py:520-552``) and builds C from those
        frequencies directly.
        """
        if reg_fi is None and reg_fij is None:
            return stats.corr_mat_from_gram(
                self._get_gram(),
                self.get_reg_single_site_freqs(),
                self.__pseudocount,
                self.msa.seqs_len,
                self.msa.q,
            )
        if reg_fi is None:
            reg_fi = self.get_reg_single_site_freqs()
        if reg_fij is None:
            reg_fij = self.get_reg_pair_site_freqs()
        l, q = self.msa.seqs_len, self.msa.q
        return _corr_mat_from_freqs(
            jnp.asarray(reg_fi), jnp.asarray(reg_fij), l, q
        )

    # -------------------------------------------------------------- couplings
    def compute_couplings(self, corr_mat=None) -> jax.Array:
        """Couplings ``-C^{-1}`` of shape (L(q-1), L(q-1)); cached.

        An explicit ``corr_mat`` (reference signature,
        ``meanfield_dca.py:555-585``) bypasses the cache.

        Reference inverts with LU (``msa_numerics.py:321-342``); C is SPD by
        construction so a Cholesky-based inverse is used here.  Under jit a
        failed Cholesky returns NaNs silently, so the result is checked and
        falls back to an LU inverse (with a warning) for non-SPD /
        ill-conditioned C — possible at very low Meff or tiny pseudocount.
        """
        if corr_mat is not None:
            return self._inverse_with_fallback(
                jnp.asarray(corr_mat).astype(self.dtype)
            )
        if self.__couplings is None:
            self._run_fused_pipeline()
        return self.__couplings

    def _run_fused_pipeline(self) -> None:
        """Populate the weights/couplings/FN caches with ONE device program.

        With a multi-chip mesh (``mesh="auto"`` and >1 device visible) the
        pipeline runs sharded: sequences data-parallel, the correlation /
        coupling matrices and the dense solve over the 'model' axis
        (:func:`pydca_tpu.parallel.fit.mfdca_sharded`).  Falls back to the
        staged LU path when C is not numerically SPD (the fused program's
        Cholesky then yields NaNs).
        """
        with self.timers.stage("pipeline"):
            if self.__mesh is not None and self.dtype == jnp.float32:
                from .parallel.fit import mfdca_sharded

                out = mfdca_sharded(
                    self.msa.data,
                    biomolecule_q=self.msa.q,
                    pseudocount=self.__pseudocount,
                    seqid=self.__seqid,
                    mesh=self.__mesh,
                    weights=self.__weights,  # reuse if already computed
                    return_all=True,
                )
                w, couplings = out["weights"], out["couplings"]
                fn_raw, fn_apc = out["fn"], out["fn_apc"]
            else:
                w, couplings, fn_raw, fn_apc = _mf_fused_pipeline(
                    jnp.asarray(self.msa.data, jnp.int32),
                    self.msa.seqs_len,
                    self.msa.q,
                    self.__seqid,
                    self.__pseudocount,
                    self.dtype,
                )
            # ONE device->host transfer: the SPD-check flag and the small
            # FN vectors ride together
            finite, fn_raw, fn_apc = jax.device_get(
                (jnp.isfinite(couplings[0, 0]), fn_raw, fn_apc)
            )
        self.timers.add_rate("pipeline", self.msa.num_seqs, "seqs")
        self.__weights = w
        if not bool(finite):
            logger.warning(
                "Cholesky factorization produced non-finite couplings "
                "(C not numerically SPD; low Meff or tiny pseudocount?); "
                "falling back to an LU inverse"
            )
            c = self.construct_corr_mat().astype(self.dtype)
            self.__couplings = -jnp.linalg.inv(c)
            self.__fn_raw = None
            self.__fn_apc = None
            return
        self.__couplings = couplings
        self.__fn_raw = fn_raw
        self.__fn_apc = fn_apc

    @staticmethod
    def _inverse_with_fallback(c: jax.Array) -> jax.Array:
        couplings = -_spd_inverse(c)
        # cheap device-side reduction; NaNs propagate to every entry of the
        # SYRK so checking one corner would also do, but be thorough
        if not bool(jnp.isfinite(couplings[0, 0])):
            logger.warning(
                "Cholesky factorization produced non-finite couplings "
                "(C not numerically SPD; low Meff or tiny pseudocount?); "
                "falling back to an LU inverse"
            )
            couplings = -jnp.linalg.inv(c)
        return couplings

    def coupling_blocks(self) -> jax.Array:
        """Per-pair coupling blocks (P, q-1, q-1) for i < j in pair order."""
        l, qm1 = self.msa.seqs_len, self.msa.q - 1
        j4 = self.compute_couplings().reshape(l, qm1, l, qm1)
        iu, ju = np.triu_indices(l, k=1)
        return j4.transpose(0, 2, 1, 3)[iu, ju]

    def compute_fields(self, couplings: Optional[jax.Array] = None) -> Dict[int, np.ndarray]:
        """Local fields ``h_i(a) = log(fi_a/fi_gap) - sum_{j != i} J_ij f_j``.

        Returns a dict {site: (q-1,) array}, mirroring ``meanfield_dca.py:588-633``.
        """
        if couplings is None:
            couplings = self.compute_couplings()
        l, q = self.msa.seqs_len, self.msa.q
        qm1 = q - 1
        fi = self.get_reg_single_site_freqs()
        fr = fi[:, :qm1]  # (L, q-1)
        j4 = couplings.reshape(l, qm1, l, qm1)
        total = jnp.einsum("iajb,jb->ia", j4, fr)
        self_term = jnp.einsum("iaib,ib->ia", j4, fr)
        fields = jnp.log(fr / fi[:, -1:]) - (total - self_term)
        fields = np.asarray(fields)
        return {i: fields[i] for i in range(l)}

    def shift_couplings(self, couplings_ij: np.ndarray) -> np.ndarray:
        """Zero-sum-gauge shift of one (q-1)^2 coupling block."""
        qm1 = self.msa.q - 1
        return np.asarray(
            score_mod.gauge_shift(jnp.asarray(couplings_ij).reshape(qm1, qm1))
        )

    def compute_two_site_model_fields(self, couplings=None, reg_fi=None) -> np.ndarray:
        """Two-site-model fields, shape ``(P, 2, q)`` (reference
        ``meanfield_dca.py:555-585`` / ``msa_numerics.py:377-442``)."""
        l, q = self.msa.seqs_len, self.msa.q
        qm1 = q - 1
        if couplings is None:
            blocks = self.coupling_blocks()
        else:
            j4 = jnp.asarray(couplings).reshape(l, qm1, l, qm1)
            iu, ju = np.triu_indices(l, k=1)
            blocks = j4.transpose(0, 2, 1, 3)[iu, ju]
        if reg_fi is None:
            reg_fi = self.get_reg_single_site_freqs()
        hi, hj = score_mod.two_site_model_fields(
            blocks, jnp.asarray(reg_fi), l, q
        )
        return np.stack([np.asarray(hi), np.asarray(hj)], axis=1)

    def get_site_pair_di_score(self) -> Dict[Tuple[int, int], float]:
        """Unsorted DI per pair as a dict ``{(i, j): score}``
        (reference ``meanfield_dca.py:793-830``)."""
        di = np.asarray(self._di_scores())
        iu, ju = np.triu_indices(self.msa.seqs_len, k=1)
        return {
            (int(i), int(j)): float(s) for i, j, s in zip(iu, ju, di)
        }

    # ----------------------------------------------------------------- scores
    def _fn_scores(self) -> jax.Array:
        # Block-reduction FN straight off the coupling matrix: avoids the
        # (L,L,q',q') transpose + P-block gather of coupling_blocks().
        # Usually already computed by the fused pipeline program.
        couplings = self.compute_couplings()
        if self.__fn_raw is not None:
            return self.__fn_raw
        return score_mod.frobenius_norms_from_matrix(
            couplings, self.msa.seqs_len, self.msa.q - 1
        )

    def _di_scores(self) -> jax.Array:
        return score_mod.direct_information(
            self.coupling_blocks(),
            self.get_reg_single_site_freqs(),
            self.msa.seqs_len,
            self.msa.q,
        )

    def compute_sorted_FN(self, seqbackmapper=None):
        res = score_mod.sorted_scores(np.asarray(self._fn_scores()), self.msa.seqs_len)
        if seqbackmapper is not None:
            res = self._map_scores(res, seqbackmapper)
        return res

    def compute_sorted_FN_APC(self, seqbackmapper=None):
        fn = self._fn_scores()
        if self.__fn_apc is not None:
            apc = self.__fn_apc
        else:
            apc = score_mod.apc(fn, self.msa.seqs_len)
        res = score_mod.sorted_scores(np.asarray(apc), self.msa.seqs_len)
        if seqbackmapper is not None:
            res = self._map_scores(res, seqbackmapper)
        return res

    def compute_sorted_DI(self, seqbackmapper=None):
        res = score_mod.sorted_scores(np.asarray(self._di_scores()), self.msa.seqs_len)
        if seqbackmapper is not None:
            res = self._map_scores(res, seqbackmapper)
        return res

    def compute_sorted_DI_APC(self, seqbackmapper=None):
        di = self._di_scores()
        apc = score_mod.apc(di, self.msa.seqs_len)
        res = score_mod.sorted_scores(np.asarray(apc), self.msa.seqs_len)
        if seqbackmapper is not None:
            res = self._map_scores(res, seqbackmapper)
        return res

    # ----------------------------------------------------------- backmapping
    def get_mapped_site_pairs_dca_scores(self, sorted_dca_scores, seqbackmapper):
        """Public name of the refseq score filter (reference
        ``meanfield_dca.py:755-790``)."""
        return self._map_scores(sorted_dca_scores, seqbackmapper)

    def _map_scores(self, sorted_dca_scores, seqbackmapper):
        """Filter/translate site pairs through a refseq mapping, re-sorted.

        Mirrors ``meanfield_dca.py:755-790``.
        """
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
        """Fields plus top-ranked gauge-shifted couplings.

        Mirrors ``meanfield_dca.py:661-752``: couplings are extracted for the
        top ``num_site_pairs`` pairs with ``|i - j| > linear_dist`` ranked by
        the chosen score, gauge-shifted per block.
        """
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
            raise MeanFieldDCAException(
                f"invalid ranking criterion {ranked_by}; choose from {tuple(methods)}"
            )
        dca_scores = methods[ranked_by](seqbackmapper=seqbackmapper)
        fields = self.compute_fields(couplings=self.compute_couplings())
        qm1 = self.msa.q - 1
        if seqbackmapper is not None:
            mapping_dict = {v: k for k, v in self.__refseq_mapping_dict.items()}
        else:
            mapping_dict = {i: i for i in range(self.msa.seqs_len)}
        if num_site_pairs is None:
            num_site_pairs = (
                len(seqbackmapper.ref_sequence)
                if seqbackmapper is not None
                else len(mapping_dict)
            )
        fields_mapped = [
            (i, fields[mapping_dict[i]]) for i in mapping_dict.keys()
        ]
        couplings_np = np.asarray(self.compute_couplings())
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
                    raise MeanFieldDCAException(
                        "site pair (i, j) should be ordered with i < j"
                    )
                block = couplings_np[i * qm1 : (i + 1) * qm1, j * qm1 : (j + 1) * qm1]
                ranked.append((pair, self.shift_couplings(block).reshape(qm1 * qm1)))
        return tuple(fields_mapped), tuple(ranked)


def _corr_mat_from_freqs(
    reg_fi: jax.Array, reg_fij: jax.Array, l: int, q: int
) -> jax.Array:
    """Build C from explicit regularized frequencies.

    ``C[(i,a),(j,b)] = fij(i,j,a,b) - fi(i,a) fj(j,b)`` over the q-1 residue
    states, diagonal blocks ``fi(a) (delta_ab - fi(b))``
    (reference ``msa_numerics.py:270-318``).
    """
    qm1 = q - 1
    fr = jnp.asarray(reg_fi)[:, :qm1]
    iu, ju = np.triu_indices(l, k=1)
    f4 = jnp.zeros((l, l, qm1, qm1), fr.dtype)
    f4 = f4.at[iu, ju].set(reg_fij)
    f4 = f4.at[ju, iu].set(jnp.swapaxes(reg_fij, -1, -2))
    diag_blocks = jax.vmap(jnp.diag)(fr)
    f4 = f4.at[jnp.arange(l), jnp.arange(l)].set(diag_blocks)
    c4 = f4 - fr[:, None, :, None] * fr[None, :, None, :]
    return c4.transpose(0, 2, 1, 3).reshape(l * qm1, l * qm1)


def _spd_inverse(c: jax.Array) -> jax.Array:
    """Inverse of a symmetric positive-definite matrix.

    Delegates to ``ops.linalg.spd_inverse``: Cholesky + divide-and-conquer
    triangular inverse + one SYRK, so the O(D^3) work runs as large
    matmuls instead of a wide ``cho_solve`` against the identity.
    """
    return linalg.spd_inverse(c)
