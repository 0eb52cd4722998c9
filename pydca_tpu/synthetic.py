"""Seeded synthetic alignments with a known answer.

Two generators, both pure NumPy and reproducible from ``seed``:

- :func:`clustered_codes`: sequences drawn around a few ancestors with a
  per-sequence mutation rate, so pairwise identities straddle the usual
  reweighting threshold and the neighbour counts are far from trivial;
- :func:`planted_alignment`: independent columns with skewed marginals,
  plus ``k`` disjoint column pairs (i, j) where the state at j copies a
  fixed permutation of the state at i with probability ``p_copy``.  Those
  pairs are the true contacts a DCA ranking must put on top.

:func:`write_fasta` renders codes through an alphabet, so the alignments
enter the engines through the same FASTA path as user data.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .alphabets import get_alphabet

__all__ = ["clustered_codes", "planted_alignment", "write_fasta"]


def clustered_codes(
    n: int, l: int, q: int, *, seed: int = 0, clusters: int = 64,
    max_mutation: float = 0.35,
) -> np.ndarray:
    """(n, l) int8 codes around ``clusters`` ancestors; each sequence
    mutates each site with its own rate drawn from [0, max_mutation]."""
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, q, size=(clusters, l), dtype=np.int8)
    out = anc[rng.integers(0, clusters, size=n)]
    rate = rng.uniform(0.0, max_mutation, size=(n, 1))
    mut = rng.random((n, l)) < rate
    return np.where(mut, rng.integers(0, q, size=(n, l), dtype=np.int8), out)


def planted_alignment(
    n: int, l: int, q: int, k: int, *, seed: int = 0, p_copy: float = 0.8,
    relatives: float = 0.3,
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """(n, l) int8 codes with ``k`` planted column pairs; returns the codes
    and the planted pairs as 0-based ``(i, j)`` with ``i < j``.

    Pairs are disjoint and at least 5 sites apart, so they survive the
    usual ``|i - j| > 4`` contact filter.
    """
    if 2 * k > l:
        raise ValueError(f"cannot plant {k} disjoint pairs in {l} columns")
    rng = np.random.default_rng(seed)
    # skewed per-column marginals: realistic, and a permutation of a
    # skewed column is not independent noise
    probs = rng.dirichlet(np.full(q, 0.7), size=l)
    cum = np.cumsum(probs, axis=1)
    u = rng.random((n, l))
    codes = (u[:, :, None] > cum[None, :, :]).sum(axis=2).clip(0, q - 1)
    codes = codes.astype(np.int8)
    pairs: List[Tuple[int, int]] = []
    free = list(rng.permutation(l))
    while len(pairs) < k:
        i = free.pop()
        j = next((c for c in free if abs(c - i) > 4), None)
        if j is None:
            raise ValueError(f"cannot plant {k} separated pairs in {l} columns")
        free.remove(j)
        i, j = min(i, j), max(i, j)
        perm = rng.permutation(q).astype(np.int8)
        copy = rng.random(n) < p_copy
        codes[:, j] = np.where(copy, perm[codes[:, i]], codes[:, j])
        pairs.append((int(i), int(j)))
    # close relatives (>80% identity to another row) give reweighting
    # real work: each keeps ~90% of its source row
    rel = rng.random(n) < relatives
    src = rng.integers(0, n, size=n)
    keep = rng.random((n, l)) < 0.9
    codes = np.where(rel[:, None] & keep, codes[src], codes)
    return codes, sorted(pairs)


def write_fasta(path: str, codes: np.ndarray, biomolecule: str) -> None:
    """Write (n, l) state codes as a FASTA alignment."""
    alphabet = get_alphabet(biomolecule)
    with open(path, "w") as fh:
        for idx, row in enumerate(np.asarray(codes)):
            fh.write(f">seq{idx}\n{alphabet.decode(row)}\n")
