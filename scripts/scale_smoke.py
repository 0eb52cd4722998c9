"""Scale smoke: exercise the framework at sizes far beyond the bundled datasets.

Three regimes the reference cannot reach (SURVEY.md §5 scaling axes):

1. deep alignment   — N = 100k sequences: tiled O(N²L) reweighting (the
   (N, N) similarity matrix never materializes) + streaming sequence-chunked
   plm fit (`seq_block`), bounding device memory at O(block·L·q);
2. long protein     — L = 1000, q = 21: the (L(q-1))² = 20k x 20k mean-field
   covariance solve on the MXU;
3. family batch     — 32 MSAs fitted in one vmapped device program.

Usage: python scripts/scale_smoke.py [deep|long|family|all]
Prints one timing line per stage.
"""

import sys
import os
# run-by-path bootstrap: make the repo root importable regardless of
# PYTHONPATH
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np


def _synthetic_msa(n, l, q, seed=0, n_clusters=64, mut=0.15):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, size=(n_clusters, l))
    msa = base[rng.integers(0, n_clusters, size=n)]
    flip = rng.random((n, l)) < mut
    return np.where(flip, rng.integers(0, q, size=(n, l)), msa).astype(np.int32)


def _t(name, fn):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    print(f"  {name}: {dt:.2f} s")
    return out, dt


def deep():
    import jax.numpy as jnp

    from pydca_tpu import stats
    from pydca_tpu.plm import fit_plm

    n, l, q = 100_000, 120, 5
    print(f"deep alignment: N={n}, L={l}, q={q} (RNA-like)")
    msa = _synthetic_msa(n, l, q)
    m = jnp.asarray(msa)

    def weights():
        w = stats.sequence_weights(m, 0.8, q)
        w.block_until_ready()
        return w

    w, dt = _t(f"sequence weights (tiled O(N²L), {n*n/1e9:.0f}G pairs)", weights)
    print(f"    -> {n * n / dt / 1e9:.1f} G pair-identities/s, Meff={float(w.sum()):.0f}")

    lam = jnp.float32(0.2 * (l - 1))

    def fit():
        r = fit_plm(m, w, lam, lam, l, q, max_iterations=10, seq_block=16384)
        r.x.block_until_ready()
        return r

    r, dt = _t("plm fit 10 iters (streaming, seq_block=16384)", fit)
    print(f"    -> {int(r.num_iters) * n / dt / 1e6:.1f} M seq-updates/s, fx={float(r.fx):.1f}")


def long_protein():
    import jax.numpy as jnp

    from pydca_tpu.meanfield import MeanFieldDCA
    from pydca_tpu.io.fasta import MSA
    from pydca_tpu.alphabets import PROTEIN

    n, l, q = 4096, 1000, 21
    print(f"long protein: N={n}, L={l}, q={q}; corr matrix {(l*(q-1))}² "
          f"({(l*(q-1))**2*4/2**30:.1f} GiB f32)")
    msa = _synthetic_msa(n, l, q, seed=1)
    mf = MeanFieldDCA(MSA(data=msa.astype(np.int8), alphabet=PROTEIN), "protein")

    _t("weights + gram", lambda: mf.get_sequences_weight().block_until_ready())
    _t("couplings = -C^{-1} (20k x 20k Cholesky solve)",
       lambda: mf.compute_couplings().block_until_ready())
    (scores, dt) = _t("FN-APC scores (all 499500 pairs)",
                      lambda: mf.compute_sorted_FN_APC()[:5])
    print(f"    -> top pair {scores[0][0]}")


def family():
    from pydca_tpu.alphabets import RNA
    from pydca_tpu.family import FamilyBatch, family_plm_fit
    from pydca_tpu.io.fasta import MSA

    f, n, l, q = 32, 512, 64, 5
    print(f"family batch: {f} MSAs of up to {n}x{l} (RNA)")
    rng = np.random.default_rng(2)
    msas = [
        MSA(
            data=_synthetic_msa(
                int(rng.integers(n // 2, n + 1)),
                int(rng.integers(l // 2, l + 1)),
                q,
                seed=k,
            ).astype(np.int8),
            alphabet=RNA,
        )
        for k in range(f)
    ]
    batch = FamilyBatch(msas)

    def fit():
        thetas, states = family_plm_fit(batch, max_iterations=20)
        thetas.block_until_ready()
        return states

    states, dt = _t("vmapped fit, 20 iters x 32 families", fit)
    print(f"    -> {f * 20 / dt:.0f} family-iterations/s")


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    from pydca_tpu.runtime import enable_compilation_cache

    enable_compilation_cache()
    if which in ("deep", "all"):
        deep()
    if which in ("long", "all"):
        long_protein()
    if which in ("family", "all"):
        family()


if __name__ == "__main__":
    main()
