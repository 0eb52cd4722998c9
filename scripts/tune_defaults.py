"""Measure the GPU defaults that pydca_tpu hard-codes, one study per run.

    python scripts/tune_defaults.py weights   # identity-count kernel vs XLA
    python scripts/tune_defaults.py crossover # default tiles vs XLA, small N
    python scripts/tune_defaults.py linalg    # spd_inverse base block, precision
    python scripts/tune_defaults.py hist      # bf16 vs f32 L-BFGS history

Each study prints one JSON object per measurement to standard output,
next to the card's name and power limit.  Times are min-of-k wall clocks
around work that ends in ``jax.block_until_ready``, after a warm-up call
that compiles.  Run it on the GPU: the studies refuse the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def record(study: str, **kv) -> None:
    print(json.dumps({"study": study, **kv, "card": CARD}), flush=True)


def timed(fn, *args, k=3):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(k):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best


# ------------------------------------------------------------------ weights
TILE_CANDIDATES = [
    # (block_i, block_j, block_k); a first sweep of bf16 planes and of
    # 64-wide tiles lost everywhere (PERF.md)
    (128, 64, 64),
    (128, 128, 64),
    (128, 128, 128),
    (256, 128, 128),
    (128, 256, 128),
    (128, 128, 256),
    (64, 128, 128),
]
SHAPES = [(8192, 120, 5), (32768, 120, 5), (100000, 120, 5), (32768, 1000, 21)]
# (N, L, q, planted pairs) of the PF02826-shape alignment; D of the inverse
PROTEIN = (2030, 195, 21, 40)
INV_D = 20000
BLOCKS = (1024, 2048, 4096)


def study_weights() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pydca_tpu import stats
    from pydca_tpu.ops.pallas_kernels import IdentityTiles, identity_counts
    from pydca_tpu.synthetic import clustered_codes

    def xla_counts(m, thr, q, block):
        return stats._sequence_weights_impl(m, jnp.float32(thr), q, block)

    # 1. compile and check every candidate at a small size, masked too
    for n, l, q in [(3000, 120, 5), (1500, 195, 21)]:
        codes = clustered_codes(n, l, q, seed=n)
        m = jnp.asarray(codes, jnp.int32)
        valid = jnp.asarray(np.random.default_rng(1).random(n) > 0.2)
        thr = 0.8 * l
        want = np.asarray(stats._sequence_weights_impl(
            m, jnp.float32(thr), q, 2048, valid, has_valid=True))
        for t in TILE_CANDIDATES:
            tiles = IdentityTiles(*t)
            try:
                got = np.asarray(identity_counts(m, thr, q, valid, tiles=tiles))
                ok = bool((got == want).all())
                err = None
            except Exception as exc:  # report every candidate's fate
                ok, err = False, f"{type(exc).__name__}: {str(exc)[:300]}"
            record("weights", phase="check", n=n, l=l, q=q, tiles=t, exact=ok,
                   error=err, mean_count=float(want.mean()))

    # 2. time XLA and each candidate at the dispatch shapes
    for n, l, q in SHAPES:
        codes = clustered_codes(n, l, q, seed=7)
        m = jnp.asarray(codes, jnp.int32)
        thr = 0.8 * l
        ref = None
        for block in (1024, 2048, 4096):
            first, best = timed(lambda a: xla_counts(a, thr, q, block), m)
            out = np.asarray(xla_counts(m, thr, q, block))
            ref = out if ref is None else ref
            record("weights", phase="time", path="xla", n=n, l=l, q=q,
                   block=block, first_s=first, best_s=best,
                   exact=bool((out == ref).all()))
        for t in TILE_CANDIDATES:
            tiles = IdentityTiles(*t)
            try:
                fn = lambda a: identity_counts(a, thr, q, tiles=tiles)  # noqa: E731
                first, best = timed(fn, m)
                exact = bool((np.asarray(fn(m)) == ref).all())
                err = None
            except Exception as exc:
                first = best = None
                exact, err = False, f"{type(exc).__name__}: {str(exc)[:300]}"
            record("weights", phase="time", path="kernel", n=n, l=l, q=q,
                   tiles=t, first_s=first, best_s=best, exact=exact, error=err)
        del m
    jax.clear_caches()


def study_crossover() -> None:
    """The default tiles against the XLA scan from shallow depths on, where
    launch costs could favour the scan (stats.identity_counts_path)."""
    import jax.numpy as jnp
    import numpy as np

    from pydca_tpu import stats
    from pydca_tpu.ops.pallas_kernels import identity_counts
    from pydca_tpu.synthetic import clustered_codes

    for l, q in ((120, 5), (195, 21)):
        for n in (16, 64, 256, 512, 2048, 8192):
            m = jnp.asarray(clustered_codes(n, l, q, seed=n), jnp.int32)
            thr = 0.8 * l
            blk = min(2048, max(8, n))
            _, xla = timed(lambda a: stats._sequence_weights_impl(
                a, jnp.float32(thr), q, blk), m, k=10)
            _, ker = timed(lambda a: identity_counts(a, thr, q), m, k=10)
            exact = bool((np.asarray(identity_counts(m, thr, q)) == np.asarray(
                stats._sequence_weights_impl(m, jnp.float32(thr), q, blk))).all())
            record("crossover", n=n, l=l, q=q, xla_best_s=xla,
                   kernel_best_s=ker, exact=exact)


# ------------------------------------------------------------------- linalg
def _mf_reference_fn_apc(codes, q, pseudocount=0.5):
    """Float64 NumPy mean-field FN-APC (tests/oracle.py maths)."""
    import numpy as np

    import oracle

    n, l = codes.shape
    w = oracle.seq_weights(codes, 0.8)
    x = np.eye(q)[codes].reshape(n, l * q)
    g = (x * w[:, None]).T @ x / w.sum()
    fi = np.diagonal(g).reshape(l, q)
    iu, ju = np.triu_indices(l, 1)
    fij = g.reshape(l, q, l, q)[:, : q - 1, :, : q - 1].transpose(0, 2, 1, 3)[iu, ju]
    c = oracle.corr_mat(
        oracle.reg_fi(fi, q, pseudocount), oracle.reg_fij(fij, q, pseudocount), l, q
    )
    fn = oracle.fn_scores(oracle.couplings(c), l, q)
    return fn, oracle.apc(fn, l)


def study_linalg() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import oracle
    from pydca_tpu.meanfield import _mf_fused_pipeline
    from pydca_tpu.ops import linalg
    from pydca_tpu.synthetic import planted_alignment

    # 1. precision of the whole mean-field chain at protein width (D=3900)
    n, l, q, k = PROTEIN
    codes, _ = planted_alignment(n, l, q, k, seed=1)
    fn64, apc64 = _mf_reference_fn_apc(codes, q)
    m = jnp.asarray(codes, jnp.int32)
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            _, _, fn, apc = _mf_fused_pipeline(m, l, q, 0.8, 0.5, jnp.float32)
            fn, apc = np.asarray(fn), np.asarray(apc)
            first, best = timed(
                lambda a: _mf_fused_pipeline(a, l, q, 0.8, 0.5, jnp.float32), m
            )
        top = lambda s: set(np.argsort(-s)[:k].tolist())  # noqa: E731
        record("linalg", phase="precision", precision=prec, d=l * (q - 1),
               spearman_fn_apc=oracle.spearman(apc, apc64),
               topk_overlap=len(top(apc) & top(apc64)) / k,
               fn_max_rel_err=float(np.max(np.abs(fn - fn64)) / np.max(np.abs(fn64))),
               pipeline_first_s=first, pipeline_best_s=best)

    # 2. base block of the triangular inverse at D=20000
    d = INV_D
    key = jax.random.PRNGKey(0)
    g = jax.random.normal(key, (d, 2048), jnp.float32)
    c = jax.block_until_ready(g @ g.T / 2048 + 0.5 * jnp.eye(d, dtype=jnp.float32))
    del g
    for prec, blocks in (("default", BLOCKS), ("highest", BLOCKS[1:2])):
        for block in blocks:
            with jax.default_matmul_precision(prec):
                fn = jax.jit(lambda a, b=block: linalg.spd_inverse(a, block=b))
                t0 = time.perf_counter()
                compiled = fn.lower(c).compile()
                compile_s = time.perf_counter() - t0
                first, best = timed(compiled, c)
                inv = compiled(c)
                # residual of C @ C^-1 on a few columns, in HIGHEST
                cols = jnp.arange(0, d, d // 16)
                r = jnp.matmul(c, inv[:, cols], precision="highest")
                r = r - jnp.eye(d, dtype=jnp.float32)[:, cols]
                resid = float(jnp.max(jnp.abs(r)))
            record("linalg", phase="base_block", precision=prec, d=d,
                   block=block, compile_s=compile_s, first_s=first,
                   best_s=best, max_residual=resid)
            del inv


# --------------------------------------------------------------------- hist
def study_hist() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import oracle
    from pydca_tpu import score as score_mod
    from pydca_tpu import stats
    from pydca_tpu.plm import fit_plm
    from pydca_tpu.synthetic import planted_alignment

    n, l, q, k = PROTEIN
    codes, pairs = planted_alignment(n, l, q, k, seed=2)
    m = jnp.asarray(codes, jnp.int32)
    w = stats.sequence_weights(m, 0.8, q)
    lam = jnp.float32(0.2 * (l - 1))
    iu, ju = np.triu_indices(l, 1)
    planted = {i * l + j for i, j in pairs}

    def fn_apc(theta):
        p = l * (l - 1) // 2
        blocks = np.asarray(theta)[l * q:].reshape(p, q, q)[:, : q - 1, : q - 1]
        fn = score_mod.frobenius_norms(jnp.asarray(blocks))
        return np.asarray(score_mod.apc(fn, l))

    scores = {}
    for hist_bf16 in (False, True, False, True):
        fit = lambda a, h=hist_bf16: fit_plm(  # noqa: E731
            a, w, lam, lam, l, q, max_iterations=100, hist_bf16=h
        ).x
        first, best = timed(fit, m)
        res = fit_plm(m, w, lam, lam, l, q, max_iterations=100, hist_bf16=hist_bf16)
        s = fn_apc(res.x)
        scores[hist_bf16] = s
        top = np.argsort(-s)[:k]
        rec = sum(int(iu[t] * l + ju[t] in planted) for t in top)
        record("hist", hist_bf16=hist_bf16, first_s=first, best_s=best,
               iters=int(res.num_iters), fx=float(res.fx), planted_top_k=rec, k=k)
    top = lambda s: set(np.argsort(-s)[:k].tolist())  # noqa: E731
    record("hist", phase="agreement",
           spearman_fn_apc=oracle.spearman(scores[True], scores[False]),
           topk_overlap=len(top(scores[True]) & top(scores[False])) / k)


def main() -> None:
    from pydca_tpu import runtime

    global CARD
    runtime.require_gpu()
    CARD = runtime.card()
    studies = {"weights": study_weights, "crossover": study_crossover,
               "linalg": study_linalg, "hist": study_hist}
    studies[sys.argv[1]]()


CARD = ""

if __name__ == "__main__":
    main()
