"""Parity + baseline harness: reference C++ plmDCA backend vs pydca_tpu.

Runs the compiled reference backend (black box, built from /root/reference into
/tmp) and our JAX engine on the same MSA, scores both parameter vectors with
our FN/FN-APC pipeline, and reports rank agreement + wall-clock.

Usage: python scripts/parity_plm.py [rf00167|pf02826] [--iters N] [--threads N]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATASETS = {
    "rf00167": ("/root/reference/examples/MSA_RF00167.fa", "rna"),
    "pf02826": ("/root/reference/tests/tests_input/PF02826.faa", "protein"),
    "rf00059": (
        "/root/reference/tests/tests_input/MSA_RF00059_trimmed_gap_treshold_50.fa",
        "rna",
    ),
}


def spearman(a, b):
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra**2).sum() * (rb**2).sum()))


def top_k_overlap(a, b, k):
    ta = set(np.argsort(-a)[:k].tolist())
    tb = set(np.argsort(-b)[:k].tolist())
    return len(ta & tb) / k


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", default="rf00167", choices=DATASETS)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--threads", type=int, default=os.cpu_count())
    ap.add_argument("--skip-ref", action="store_true")
    ap.add_argument("--golden-dir", default="tests/goldens")
    args = ap.parse_args()

    msa_file, biomolecule = DATASETS[args.dataset]

    import ref_backend
    from pydca_tpu import read_msa
    from pydca_tpu.plm import PlmDCA
    from pydca_tpu import score as score_mod
    import jax.numpy as jnp

    msa = read_msa(msa_file, biomolecule)
    l, q = msa.seqs_len, msa.q
    print(f"{args.dataset}: N={msa.num_seqs} (dedup), L={l}, q={q}")

    golden_path = os.path.join(
        args.golden_dir, f"ref_plm_{args.dataset}_it{args.iters}.npz"
    )
    if os.path.exists(golden_path) and not args.skip_ref:
        z = np.load(golden_path)
        ref_params, ref_time = z["params"], float(z["seconds"])
        print(f"loaded reference golden ({ref_time:.1f}s recorded)")
    else:
        # the C++ backend reads the raw file itself (its own reader/dedup)
        ids, seqs = [], []
        with open(msa_file) as fh:
            pass
        t0 = time.time()
        ref_params = ref_backend.run_backend(
            msa_file,
            biomolecule,
            l,
            seqid=0.8,
            max_iterations=args.iters,
            num_threads=args.threads,
            verbose=False,
        )
        ref_time = time.time() - t0
        os.makedirs(args.golden_dir, exist_ok=True)
        np.savez_compressed(golden_path, params=ref_params, seconds=ref_time)
        print(f"reference backend: {ref_time:.1f}s ({args.threads} threads)")

    # ---- our engine ----
    inst = PlmDCA(msa, biomolecule, max_iterations=args.iters)
    t0 = time.time()
    params = inst.get_fields_and_couplings_from_backend()
    our_time = time.time() - t0
    res = inst.fit_result
    print(
        f"pydca_tpu: {our_time:.2f}s  iters={int(res.num_iters)} "
        f"fx={float(res.fx):.4f} |g|={float(res.gnorm):.3e} "
        f"conv={bool(res.converged)} ls_fail={bool(res.linesearch_failed)}"
    )

    # ---- score both with the same pipeline ----
    def fn_and_apc(param_vec):
        p = l * (l - 1) // 2
        blocks = param_vec[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]
        fn = np.asarray(score_mod.frobenius_norms(jnp.asarray(blocks)))
        ap_ = np.asarray(score_mod.apc(jnp.asarray(fn), l))
        return fn, ap_

    fn_ref, apc_ref = fn_and_apc(ref_params)
    fn_our, apc_our = fn_and_apc(params)

    out = {
        "dataset": args.dataset,
        "ref_seconds": ref_time,
        "our_seconds": our_time,
        "speedup": ref_time / our_time,
        "spearman_fn": spearman(fn_ref, fn_our),
        "spearman_fn_apc": spearman(apc_ref, apc_our),
        "top20_overlap_apc": top_k_overlap(apc_ref, apc_our, 20),
        "top50_overlap_apc": top_k_overlap(apc_ref, apc_our, 50),
        "topL_overlap_apc": top_k_overlap(apc_ref, apc_our, l),
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
