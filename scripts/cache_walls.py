"""Wall time and new compile-cache entries of k fresh CLI processes.

    python scripts/cache_walls.py [--runs 2] [--seed 0]

Writes a planted protein alignment (2030 x 195, q=21, the PF02826 shape),
then runs ``mfdca compute_fn protein <file> --apc`` in ``--runs`` fresh
processes, one after another.  For each it prints the process wall and the
number of entries it added to the persistent compile cache
(``pydca_tpu.runtime.cache_dir()``: ``JAX_COMPILATION_CACHE_DIR`` when set,
else ``.jax_cache/`` at the checkout root).  On a warm cache a process adds
none.  This process never starts JAX on a device, so each child has the card
to itself.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def count_entries(path: str) -> int:
    if not os.path.isdir(path):
        return 0
    return sum(len(files) for _, _, files in os.walk(path))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    # importing these starts no JAX backend: the children get the card
    from pydca_tpu import runtime
    from pydca_tpu.synthetic import planted_alignment, write_fasta

    cache = runtime.cache_dir()
    card = runtime.card()
    with tempfile.TemporaryDirectory() as tmp:
        msa = os.path.join(tmp, "planted_protein.faa")
        write_fasta(msa, planted_alignment(2030, 195, 21, 40, seed=args.seed)[0],
                    "protein")
        cmd = [sys.executable, "-m", "pydca_tpu.cli.mfdca_main", "compute_fn",
               "protein", msa, "--apc", "--output_dir", os.path.join(tmp, "out")]
        for run in range(args.runs):
            before = count_entries(cache)
            t0 = time.perf_counter()
            subprocess.run(cmd, cwd=REPO, check=True, capture_output=True)
            wall = time.perf_counter() - t0
            print(json.dumps({
                "run": run, "process_wall_s": wall, "cache": cache,
                "cache_entries_added": count_entries(cache) - before,
                "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
