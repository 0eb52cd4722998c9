"""Optimization-quality comparison vs the reference backend on all datasets.

For each bundled dataset: evaluate OUR objective at the reference backend's
committed final parameters (tests/goldens/ref_plm_*_it100.npz) and run our
fit under the same budget (100 iterations, m=5), reporting final fx,
iteration count and line-search exit status.  Both parameter vectors are
scored by the same loss, so 'fx_ours < fx_ref_params' means our optimizer
found a strictly better point of the identical objective within the budget.

Usage: python scripts/fx_trajectory.py [--progress]  (runs on the default
backend: the GPU when one is visible, else the CPU)
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DATASETS = {
    "rf00167": ("/root/reference/examples/MSA_RF00167.fa", "rna"),
    "pf02826": ("/root/reference/tests/tests_input/PF02826.faa", "protein"),
    "rf00059": (
        "/root/reference/tests/tests_input/MSA_RF00059_trimmed_gap_treshold_50.fa",
        "rna",
    ),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("datasets", nargs="*", default=list(DATASETS))
    args = ap.parse_args()

    from pydca_tpu.runtime import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from pydca_tpu import read_msa, stats
    from pydca_tpu.plm import fit_plm, plm_loss

    results = {}
    for name in args.datasets or list(DATASETS):
        msa_file, biomolecule = DATASETS[name]
        msa = read_msa(msa_file, biomolecule)
        l, q = msa.seqs_len, msa.q
        m = jnp.asarray(msa.data, jnp.int32)
        w = stats.sequence_weights(m, 0.8, q)
        lam = jnp.float32(0.2 * (l - 1))
        pidx = jnp.asarray(stats.pair_index_matrix(l))

        golden = np.load(
            os.path.join(REPO, "tests", "goldens", f"ref_plm_{name}_it100.npz")
        )
        fx_ref = float(
            plm_loss(
                jnp.asarray(golden["params"]), m, w, pidx, lam, lam, l, q
            )
        )

        progress = None
        if args.progress:
            traj = []

            def progress(state, traj=traj):
                traj.append(float(state.fx))

        t0 = time.time()
        res = fit_plm(
            m, w, lam, lam, l, q, max_iterations=100,
            chunk_size=10 if args.progress else 50, progress_fn=progress,
        )
        res.x.block_until_ready()
        dt = time.time() - t0
        out = {
            "fx_ours": round(float(res.fx), 2),
            "fx_ref_params": round(fx_ref, 2),
            "better_than_ref": bool(float(res.fx) < fx_ref),
            "iters": int(res.num_iters),
            "converged": bool(res.converged),
            "linesearch_failed": bool(res.linesearch_failed),
            "gnorm": float(res.gnorm),
            "seconds": round(dt, 2),
        }
        results[name] = out
        print(name, json.dumps(out), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
