#!/usr/bin/env python3
"""End-to-end smoke test of pydca_tpu on an NVIDIA GPU.

    python chip_smoke.py               # one card: both engines, DI, weights
    python chip_smoke.py --four-cards  # only the multi-device path, 4 cards

Drives the user entry points (``run_meanfield_dca`` and ``run_plm_dca``, the
functions behind the ``mfdca`` and ``plmdca`` commands, plus the
``MeanFieldDCA``/``PlmDCA`` library classes) at the full width of the
bundled alignments, on planted alignments generated from ``--seed``:
protein 2030 x 195 (q=21, the PF02826 shape) and RNA 2704 x 102 (q=5, the
RF00167 shape).  Every phase checks its output against a plain reference
and prints its wall time next to the card's name and power limit; any
failed check exits non-zero.  The last line is one JSON object naming the
device.  Everything runs in this one process: a JAX process reserves most
of the card's memory, so no second process may use the card meanwhile.

Tolerances (the GPU runs float32 matmuls as TF32 at JAX's DEFAULT
precision; each bound below is set from readings on an H100, PERF.md):

- identity counts: exact — 0/1 products summed to at most L are exact in
  every path, so any difference is a bug;
- mean-field FN-APC vs the float64 oracle: Spearman >= 0.99 and top-K
  overlap >= 0.9 (ranking is what users read); FN max relative error and
  couplings relative Frobenius error <= 1e-3, about 2x the largest TF32
  reading (4.5e-4; HIGHEST reads 1.3e-6);
- planted recovery: >= 0.9 K of the K planted pairs in the top K of both
  engines (the planted copy probability 0.8 makes them unmistakable);
- plm loss and gradient vs the float64 oracle, at the fitted parameters
  and with their couplings halved (where the gradient is far from zero):
  |f - f64| / |f64| <= 3e-6; at the fitted point
  ||g - g64|| / ||g_abs|| <= 1e-4, where g_abs is the gradient of the
  absolute terms (the scale TF32 rounding errors are proportional to; the
  gradient itself nearly vanishes there); with the couplings halved the
  plain ||g - g64|| / ||g64|| <= 2.5e-4.  Each bound lies about 2.5x
  above the largest TF32 reading on an H100 and about 2.5x below the
  smallest reading with bf16 logits operands (PERF.md); a bf16-operand
  evaluation runs as a control and must fail every bound;
- four cards vs one: FN-APC Spearman >= 0.999 and the same top-K, and
  fitted losses within 1e-6 relative: only the summation order differs,
  and four H100s read 1.4e-7 and 7.1e-8 (PERF.md).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# bounds against the float64 oracle, from readings on an H100 (docstring)
MF_REL_TOL = 1e-3
PLM_LOSS_TOL = 3e-6
PLM_GRAD_ABS_TOL = 1e-4
PLM_GRAD_REL_TOL = 2.5e-4
K_PROTEIN, K_RNA = 40, 20
CARD = ""


class CheckFailed(AssertionError):
    pass


def check(name: str, value, op: str, tol) -> None:
    """Print a comparison beside its tolerance; fail when it does not hold."""
    ok = {"<=": value <= tol, ">=": value >= tol, ">": value > tol,
          "==": value == tol}[op]
    print(f"  {name}: {value!r} (need {op} {tol!r}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise CheckFailed(f"{name} = {value!r}, need {op} {tol!r}")


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's name, then its wall time next to the card."""
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s on {CARD}", flush=True)


# ------------------------------------------------------------------ helpers
def pair_ids(pairs, l: int):
    import numpy as np

    i = np.asarray([p[0] for p in pairs], np.int64)
    j = np.asarray([p[1] for p in pairs], np.int64)
    return l * (l - 1) // 2 - (l - i) * (l - i - 1) // 2 + j - i - 1


def read_scores(out_dir: str, prefix: str, l: int):
    """Parse one score file: ``#`` header, then 1-based ``i j score`` lines
    in descending score order; returns the dense pair-order vector."""
    import numpy as np

    files = [f for f in os.listdir(out_dir) if f.startswith(prefix)]
    check(f"{prefix}* files", len(files), "==", 1)
    header, late_header, rows = 0, 0, []
    with open(os.path.join(out_dir, files[0])) as fh:
        for line in fh:
            if line.startswith("#"):
                header += 1
                late_header += bool(rows)
                continue
            i, j, s = line.split()
            rows.append((int(i) - 1, int(j) - 1, float(s)))
    check("'#' header lines", header > 0, "==", True)
    check("'#' lines after the scores", late_header, "==", 0)
    check("score lines", len(rows), "==", l * (l - 1) // 2)
    vals = [s for _, _, s in rows]
    check("descending", vals == sorted(vals, reverse=True), "==", True)
    check("all finite", bool(np.isfinite(vals).all()), "==", True)
    dense = np.full(l * (l - 1) // 2, np.nan)
    dense[pair_ids([(i, j) for i, j, _ in rows], l)] = vals
    check("every pair once", bool(np.isfinite(dense).all()), "==", True)
    return dense


def recovered(scores, planted, l: int) -> int:
    import numpy as np

    k = len(planted)
    return len(set(np.argsort(-scores)[:k]) & set(pair_ids(planted, l)))


# ------------------------------------------------------------------- phases
def phase_meanfield(f_prot, codes, planted, out_dir):
    import numpy as np

    import oracle
    from pydca_tpu.cli.mfdca_main import run_meanfield_dca
    from pydca_tpu.meanfield import MeanFieldDCA

    n, l = codes.shape
    q = 21
    run_meanfield_dca(["compute_fn", "protein", f_prot, "--apc",
                       "--output_dir", out_dir])
    apc = read_scores(out_dir, "MFDCA_apc_fn_scores_", l)
    check("mfDCA planted pairs in top K", recovered(apc, planted, l), ">=",
          int(0.9 * len(planted)))

    inst = MeanFieldDCA(f_prot, "protein")
    codes = np.asarray(inst.msa.data, np.int64)  # as the engine read them
    couplings = np.asarray(inst.compute_couplings(), np.float64)
    w = np.asarray(inst.get_sequences_weight(), np.float64)
    fn = np.asarray(inst._fn_scores(), np.float64)

    # float64 oracle (tests/oracle.py); the pair frequencies come from a
    # float64 one-hot product, as the oracle's loop form is too slow here
    w64 = oracle.seq_weights(codes, 0.8)
    check("weights: neighbour counts exact",
          bool((np.rint(1 / w) == np.rint(1 / w64)).all()), "==", True)
    x = np.eye(q)[codes].reshape(n, l * q)
    g = (x * w64[:, None]).T @ x / w64.sum()
    fi = np.diagonal(g).reshape(l, q)
    iu, ju = np.triu_indices(l, 1)
    fij = g.reshape(l, q, l, q)[:, : q - 1, :, : q - 1].transpose(0, 2, 1, 3)
    c = oracle.corr_mat(oracle.reg_fi(fi, q, 0.5),
                        oracle.reg_fij(fij[iu, ju], q, 0.5), l, q)
    j64 = oracle.couplings(c)
    fn64 = oracle.fn_scores(j64, l, q)
    apc64 = oracle.apc(fn64, l)
    check("FN-APC Spearman vs float64 oracle", oracle.spearman(apc, apc64),
          ">=", 0.99)
    check("FN-APC top-K overlap vs oracle",
          oracle.top_overlap(apc, apc64, len(planted)), ">=", 0.9)
    check("FN max relative error",
          float(np.abs(fn - fn64).max() / np.abs(fn64).max()), "<=",
          MF_REL_TOL)
    check("couplings relative Frobenius error",
          float(np.linalg.norm(couplings - j64) / np.linalg.norm(j64)), "<=",
          MF_REL_TOL)


def phase_plm(f_prot, codes, planted, out_dir):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import oracle
    from pydca_tpu import stats
    from pydca_tpu.cli.plmdca_main import run_plm_dca
    from pydca_tpu.plm import PlmDCA, plm_loss_and_grad

    n, l = codes.shape
    q = 21
    run_plm_dca(["compute_fn", "protein", f_prot, "--apc",
                 "--max_iterations", "100", "--output_dir", out_dir])
    apc = read_scores(out_dir, "PLMDCA_apc_fn_scores_", l)
    check("plmDCA planted pairs in top K", recovered(apc, planted, l), ">=",
          int(0.9 * len(planted)))

    inst = PlmDCA(f_prot, "protein", max_iterations=100)
    check("logits operands (production default)",
          "bf16" if inst.mm_bf16 else "f32", "==", "f32")
    theta = inst.get_fields_and_couplings_from_backend()
    w = inst.compute_seqs_weight()
    lam = 0.2 * (l - 1)
    m = jnp.asarray(inst.msa.data, jnp.int32)
    loss_grad = jax.jit(plm_loss_and_grad, static_argnums=(6, 7, 8))
    # the fitted point, and one with its couplings halved, where the
    # gradient is far from zero and a plain relative error is a bound
    half = theta.copy()
    half[l * q:] *= 0.5
    for point, th, grad_tol, grad_scale in (
        ("fitted", theta, PLM_GRAD_ABS_TOL, "||g_abs||"),
        ("couplings halved", half, PLM_GRAD_REL_TOL, "||g64||"),
    ):
        f64, g64, gabs = oracle.plm_loss_and_grad(
            th.astype(np.float64), np.asarray(inst.msa.data, np.int64),
            np.asarray(w, np.float64), lam, lam, q, term_scale=True,
        )
        scale = np.linalg.norm(gabs if grad_scale == "||g_abs||" else g64)
        for mm_bf16 in (False, True):
            f, g = loss_grad(
                jnp.asarray(th), m, w, jnp.asarray(stats.pair_index_matrix(l)),
                jnp.float32(lam), jnp.float32(lam), l, q, mm_bf16,
            )
            loss_err = abs(float(f) - f64) / abs(f64)
            grad_err = float(np.linalg.norm(np.asarray(g, np.float64) - g64)
                             / scale)
            if not mm_bf16:
                check(f"plm loss relative error ({point})", loss_err, "<=",
                      PLM_LOSS_TOL)
                check(f"plm gradient error / {grad_scale} ({point})",
                      grad_err, "<=", grad_tol)
            else:
                # control: bf16 operands must fail the bounds above, or
                # they could not catch a precision fault
                check(f"bf16-operand control: loss error ({point})",
                      loss_err, ">", PLM_LOSS_TOL)
                check(f"bf16-operand control: gradient error / {grad_scale} "
                      f"({point})", grad_err, ">", grad_tol)


def phase_di(f_rna, l, out_dir):
    from pydca_tpu.cli.plmdca_main import run_plm_dca

    run_plm_dca(["compute_di", "rna", f_rna, "--apc", "--max_iterations",
                 "20", "--output_dir", out_dir])
    read_scores(out_dir, "PLMDCA_apc_di_scores_", l)


def phase_weights(seed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pydca_tpu import stats
    from pydca_tpu.synthetic import clustered_codes

    for n, l, q in ((100_000, 120, 5), (32_768, 1000, 21)):
        print(f"  N={n}, L={l}, q={q}", flush=True)
        codes = clustered_codes(n, l, q, seed=seed + n)
        m = jnp.asarray(codes, jnp.int32)
        thr = 0.8 * l
        check("dispatched path", stats.identity_counts_path(), "==", "kernel")
        hlo = stats._kernel_counts.lower(m, thr, q).as_text()
        check("compiled Triton kernel in the program",
              "triton" in hlo.lower(), "==", True)
        t0 = time.perf_counter()
        w = jax.block_until_ready(stats.sequence_weights(m, 0.8, q))
        print(f"  sequence_weights: {time.perf_counter() - t0:.3f} s "
              "(first call, compile included)")
        counts = np.rint(1.0 / np.asarray(w, np.float64)).astype(np.int64)
        xla = np.asarray(
            stats._sequence_weights_impl(m, jnp.float32(thr), q, 2048)
        )
        check("kernel counts == XLA scan counts (all rows)",
              int((counts != xla).sum()), "==", 0)
        rows = np.random.default_rng(seed).choice(n, 256, replace=False)
        brute = np.array([
            ((codes[r] == codes).sum(1) > np.float32(thr)).sum() for r in rows
        ])
        check("kernel counts == NumPy brute force (256 rows)",
              int((counts[rows] != brute).sum()), "==", 0)
        check("mean neighbour count > 1 (non-trivial data)",
              float(counts.mean()) > 1.0, "==", True)
        del m


# -------------------------------------------------------------- four cards
def four_cards(f_prot, codes, planted, seed):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import oracle
    from pydca_tpu.parallel import make_mesh, mfdca_sharded
    from pydca_tpu.plm import PlmDCA
    from pydca_tpu import score as score_mod
    from pydca_tpu.synthetic import planted_alignment

    check("visible devices", len(jax.devices()), "==", 4)

    with phase("four cards: reweighting N=32768 data-parallel (kernel)"):
        from pydca_tpu import stats
        from pydca_tpu.parallel.fit import sequence_weights_sharded
        from pydca_tpu.synthetic import clustered_codes

        deep = jnp.asarray(clustered_codes(32_768, 120, 5, seed=seed), jnp.int32)
        check("dispatched path", stats.identity_counts_path(), "==", "kernel")
        w4 = np.asarray(sequence_weights_sharded(make_mesh(4, 1), deep, 0.8, 5))
        w1 = np.asarray(stats.sequence_weights(deep, 0.8, 5))
        check("weights differing 4 cards vs 1", int((w4 != w1).sum()), "==", 0)
    l = codes.shape[1]
    k = len(planted)

    def plm_scores(inst):
        theta = inst.get_fields_and_couplings_from_backend()
        q = 21
        p = l * (l - 1) // 2
        blocks = theta[l * q:].reshape(p, q, q)[:, : q - 1, : q - 1]
        fn = score_mod.frobenius_norms(jnp.asarray(blocks))
        return np.asarray(score_mod.apc(fn, l)), float(inst.fit_result.fx)

    for label, kw in (("plm fit, --mesh auto", {}),
                      ("streaming plm fit, seq_block=512", {"seq_block": 512})):
        with phase(f"four cards: {label}"):
            inst4 = PlmDCA(f_prot, "protein", mesh="auto", **kw)
            check("'data' axis of the resolved mesh",
                  dict(inst4.mesh.shape).get("data"), "==", 4)
            multi, fx4 = plm_scores(inst4)
            check("devices holding the sequence weights",
                  len(inst4.compute_seqs_weight().sharding.device_set), "==", 4)
            one, fx1 = plm_scores(PlmDCA(f_prot, "protein", mesh=None, **kw))
            check("FN-APC Spearman 4 cards vs 1", oracle.spearman(multi, one),
                  ">=", 0.999)
            check("top-K overlap 4 cards vs 1",
                  oracle.top_overlap(multi, one, k), ">=", 1.0)
            check("fitted loss relative difference", abs(fx4 - fx1) / abs(fx1),
                  "<=", 1e-6)
            check("planted pairs in top K (4 cards)",
                  recovered(multi, planted, l), ">=", int(0.9 * k))

    with phase("four cards: mfdca_sharded L=1000, q=21, model axis"):
        from pydca_tpu.meanfield import MeanFieldDCA

        big, big_planted = planted_alignment(4000, 1000, 21, 100, seed=seed)
        lb, kb = big.shape[1], len(big_planted)
        fn4, apc4 = mfdca_sharded(big, biomolecule_q=21,
                                  mesh=make_mesh(1, 4))
        apc4 = np.asarray(apc4)
        inst = MeanFieldDCA(big, "protein")
        apc1 = np.asarray(score_mod.apc(inst._fn_scores(), lb))
        check("FN-APC Spearman 4 cards vs 1", oracle.spearman(apc4, apc1),
              ">=", 0.999)
        check("top-K overlap 4 cards vs 1", oracle.top_overlap(apc4, apc1, kb),
              ">=", 0.99)
        check("planted pairs in top K (4 cards)",
              recovered(apc4, big_planted, lb), ">=", int(0.9 * kb))


# ---------------------------------------------------------------------- main
def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path, on 4 cards")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(REPO, "pydca_tpu")):
        raise SystemExit(f"{REPO} holds no pydca_tpu checkout")
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import jax

    from pydca_tpu import runtime
    from pydca_tpu.synthetic import planted_alignment, write_fasta

    # device first: a missing CUDA plugin is an error, not a CPU run
    dev = runtime.require_gpu()
    CARD = runtime.card()
    print(f"card: {CARD}", flush=True)

    cache = runtime.enable_compilation_cache()  # before the first compile
    print(f"compile cache: {cache}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        prot, prot_pairs = planted_alignment(2030, 195, 21, K_PROTEIN,
                                             seed=args.seed)
        rna, _ = planted_alignment(2704, 102, 5, K_RNA, seed=args.seed + 1)
        f_prot = os.path.join(tmp, "planted_protein.faa")
        f_rna = os.path.join(tmp, "planted_rna.fa")
        write_fasta(f_prot, prot, "protein")
        write_fasta(f_rna, rna, "rna")

        if args.four_cards:
            four_cards(f_prot, prot, prot_pairs, args.seed)
        else:
            with phase("1. mfdca compute_fn protein 2030x195 --apc"):
                phase_meanfield(f_prot, prot, prot_pairs,
                                os.path.join(tmp, "mf"))
            with phase("2. plmdca compute_fn protein 2030x195 --apc, 100 it"):
                phase_plm(f_prot, prot, prot_pairs, os.path.join(tmp, "plm"))
            with phase("3. plmdca compute_di rna 2704x102 --apc, 20 it"):
                phase_di(f_rna, rna.shape[1], os.path.join(tmp, "di"))
            with phase("4. reweighting through stats.sequence_weights"):
                phase_weights(args.seed)
            with phase("5. compile cache"):
                entries = len(os.listdir(cache)) if cache else 0
                check(f"entries in {cache}", entries, ">=", 1)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
