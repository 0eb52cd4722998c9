"""Aligner + backmapper + trimmer characterization tests."""

import numpy as np
import pytest

from pydca_tpu import align as align_mod
from pydca_tpu import matrices
from pydca_tpu.backmap import SequenceBackmapper
from pydca_tpu.trim import MSATrimmer

from conftest import reference_file


def _score_pair(a, b, biomolecule, letters):
    sub = matrices.submatrix_for(biomolecule, letters)
    go, ge = matrices.gap_penalties_for(biomolecule)
    from pydca_tpu.alphabets import get_alphabet

    alph = get_alphabet(biomolecule)
    s, *_ = align_mod.local_align(
        alph.encode_str(a), alph.encode_str(b), sub, go, ge
    )
    return s


def test_local_align_simple_match():
    # identical RNA sequences: score = 5 * len
    assert _score_pair("ACGUACGU", "ACGUACGU", "rna", "ACGU") == 40


def test_local_align_substring():
    # local alignment finds the embedded substring
    assert _score_pair("ACGU", "GGGACGUGGG", "rna", "ACGU") == 20


def test_local_align_with_gap():
    # ACGU vs ACGGU: best local has one gap (open -8, extend 0)
    s = _score_pair("ACGUACGU", "ACGUXACGU".replace("X", "G"), "rna", "ACGU")
    assert s == 40 - 8


def test_local_align_path_consistency():
    from pydca_tpu.alphabets import RNA

    sub = matrices.submatrix_for("rna", "ACGU")
    a = RNA.encode_str("ACGGUACGU")
    b = RNA.encode_str("CCACGUACGUAA")
    score, a0, b0, path = align_mod.local_align(a, b, sub, -8.0, 0.0)
    sa, sb = align_mod.aligned_strings("ACGGUACGU", "CCACGUACGUAA", a0, b0, path)
    assert len(sa) == len(sb) == len(path)
    # recompute score from the rendered alignment
    s = 0.0
    in_gap = False
    for ca, cb in zip(sa, sb):
        if ca == "-" or cb == "-":
            s += 0.0 if in_gap else -8.0
            in_gap = True
        else:
            s += 5 if ca == cb else -4
            in_gap = False
    assert s == score


def test_batch_scores_match_single():
    from pydca_tpu.alphabets import RNA

    rng = np.random.default_rng(0)
    sub = matrices.submatrix_for("rna", "ACGU")
    ref = rng.integers(0, 4, size=25).astype(np.int32)
    temps = []
    lengths = []
    for _ in range(12):
        ln = int(rng.integers(8, 30))
        temps.append(rng.integers(0, 4, size=ln).astype(np.int32))
        lengths.append(ln)
    wmax = max(lengths)
    padded = np.full((len(temps), wmax), -1, dtype=np.int32)
    for k, t in enumerate(temps):
        padded[k, : len(t)] = t
    batch = align_mod.batch_local_align_scores(ref, padded, sub, -8.0, 0.0, -1)
    for k, t in enumerate(temps):
        s, *_ = align_mod.local_align(ref, t, sub, -8.0, 0.0)
        assert batch[k] == pytest.approx(s), k


def test_align_subsequences_gap_reinsertion():
    # template MSA portion has gaps; they must be inserted into the ref portion
    out = SequenceBackmapper.align_subsequences("ACGU", "AC--GU", 4)
    assert out == "AC--GU"


def test_backmapper_rna(rf00059_path):
    bm = SequenceBackmapper(
        msa_file=rf00059_path, refseq_file=reference_file("rf00059_ref"),
        biomolecule="rna",
    )
    mapping = bm.map_to_reference_sequence()
    assert len(mapping) > 1  # the reference test asserts this
    # keys are MSA columns, values refseq positions
    L_msa = len(bm.alignment[0])
    L_ref = len(bm.ref_sequence)
    for col, pos in mapping.items():
        assert 0 <= col < L_msa
        assert 0 <= pos < L_ref
    # mapping must be strictly increasing in both coordinates
    cols = sorted(mapping)
    vals = [mapping[c] for c in cols]
    assert vals == sorted(vals)
    assert len(set(vals)) == len(vals)


def test_backmapper_protein(pf02826_path):
    bm = SequenceBackmapper(
        msa_file=pf02826_path, refseq_file=reference_file("pf02826_ref"),
        biomolecule="protein",
    )
    mapping = bm.map_to_reference_sequence()
    assert len(mapping) > 1


def test_trimmer_by_gap_size(rf00059_path):
    # already trimmed at 50% threshold upstream -> nothing above 0.5
    trimmer = MSATrimmer(rf00059_path, biomolecule="rna", max_gap=0.5)
    cols = trimmer.trim_by_gap_size()
    gaps = trimmer.compute_msa_columns_gap_size()
    for c in cols:
        assert gaps[c] > 0.5
    strict = MSATrimmer(rf00059_path, biomolecule="rna", max_gap=0.05)
    assert len(strict.trim_by_gap_size()) > len(cols)


def test_trimmer_by_refseq(rf00059_path):
    trimmer = MSATrimmer(
        rf00059_path, biomolecule="rna",
        refseq_file=reference_file("rf00059_ref"),
    )
    cols = trimmer.trim_by_refseq(remove_all_gaps=True)
    trimmed = trimmer.get_msa_trimmed_by_refseq(remove_all_gaps=True)
    orig_len = len(trimmer.alignment_sequences[0])
    assert all(len(s) == orig_len - len(cols) for _, s in trimmed)
    assert len(trimmed) == len(trimmer.alignment_sequences)


def _variant_path(k):
    return reference_file(f"rf00059_test{k}")


@pytest.fixture(scope="module")
def variant_mappings(rf00059_path):
    """Backmap RF00059 against the four refseq variants.

    The variants are sub/supersequences of each other
    (test2 = test1[4:], test3 = test1[:87], test4 = test1[4:87]), which
    characterizes the gap-reinsertion walk of ``map_to_reference_sequence``
    (reference ``sequence_backmapper.py:339-466``) without a Biopython oracle.
    """
    out = {}
    for k in (1, 2, 3, 4):
        bm = SequenceBackmapper(
            msa_file=rf00059_path, refseq_file=_variant_path(k), biomolecule="rna"
        )
        out[k] = (bm.map_to_reference_sequence(), len(bm.ref_sequence))
    return out


def test_backmap_variants_monotonic_and_in_range(variant_mappings):
    for k, (mapping, ref_len) in variant_mappings.items():
        assert len(mapping) > 1, k
        cols = sorted(mapping)
        vals = [mapping[c] for c in cols]
        assert vals == sorted(vals), k
        assert len(set(vals)) == len(vals), k
        assert all(0 <= v < ref_len for v in vals), k


def test_backmap_variant_offsets_consistent(variant_mappings):
    m1, _ = variant_mappings[1]
    # test2 drops the first 4 residues of test1: shared columns shift by -4
    m2, _ = variant_mappings[2]
    shared = [c for c in m1 if c in m2 and m1[c] >= 4]
    assert len(shared) > 40
    assert all(m2[c] == m1[c] - 4 for c in shared)
    # test3 truncates test1's tail: shared columns map identically
    m3, _ = variant_mappings[3]
    shared = [c for c in m1 if c in m3 and m1[c] < 87]
    assert len(shared) > 40
    assert all(m3[c] == m1[c] for c in shared)
    # test4 does both
    m4, _ = variant_mappings[4]
    shared = [c for c in m1 if c in m4 and 4 <= m1[c] < 87]
    assert len(shared) > 40
    assert all(m4[c] == m1[c] - 4 for c in shared)


# ---------------------------------------------------------------- golden pins
REF_BACKMAP_CASES = {
    "rf00167": ("rf00167", "rf00167_ref", "rna"),
    "pf02826": ("pf02826", "pf02826_ref", "protein"),
    "rf00059": ("rf00059", "rf00059_ref", "rna"),
    **{
        f"rf00059_test{k}": ("rf00059", f"rf00059_test{k}", "rna")
        for k in (1, 2, 3, 4)
    },
}


@pytest.mark.parametrize("name", sorted(REF_BACKMAP_CASES))
def test_backmap_matches_reference_golden(name):
    """Pin map_to_reference_sequence exactly against the reference
    backmapper's walk (goldens from scripts/gen_backmap_goldens.py, which
    executes the reference code with only the alignment engine stubbed)."""
    import os

    golden = np.load(
        os.path.join(os.path.dirname(__file__), "goldens", "ref_backmap.npz")
    )
    msa_file, refseq_file, biomolecule = REF_BACKMAP_CASES[name]
    bm = SequenceBackmapper(
        msa_file=reference_file(msa_file),
        refseq_file=reference_file(refseq_file),
        biomolecule=biomolecule,
    )
    mapping = bm.map_to_reference_sequence()
    keys = np.array(sorted(mapping), dtype=np.int32)
    vals = np.array([mapping[k] for k in keys], dtype=np.int32)
    np.testing.assert_array_equal(keys, golden[f"{name}_msa_sites"])
    np.testing.assert_array_equal(vals, golden[f"{name}_ref_sites"])


TRIM_CASES = {
    "rf00059_refseq": ("rf00059", "rf00059_ref", "rna"),
    "rf00167_refseq": ("rf00167", "rf00167_ref", "rna"),
    "pf02826_refseq": ("pf02826", "pf02826_ref", "protein"),
}


@pytest.mark.parametrize("name", sorted(TRIM_CASES))
@pytest.mark.parametrize("remove_all_gaps", [False, True])
def test_trim_by_refseq_matches_reference_golden(name, remove_all_gaps):
    """Pin trim_by_refseq column selection exactly against the reference
    trimmer (goldens from scripts/gen_trim_goldens.py)."""
    import os

    golden = np.load(
        os.path.join(os.path.dirname(__file__), "goldens", "ref_trim.npz")
    )
    msa_file, refseq_file, biomolecule = TRIM_CASES[name]
    tr = MSATrimmer(
        reference_file(msa_file), biomolecule=biomolecule,
        refseq_file=reference_file(refseq_file),
    )
    cols = np.asarray(tr.trim_by_refseq(remove_all_gaps=remove_all_gaps), np.int32)
    key = f"{name}_cols_all" if remove_all_gaps else f"{name}_cols"
    np.testing.assert_array_equal(cols, golden[key])


@pytest.mark.parametrize("key,max_gap", [("rf00167", 0.5), ("pf02826", 0.4)])
def test_trim_by_gap_size_matches_reference_golden(key, max_gap):
    import os

    golden = np.load(
        os.path.join(os.path.dirname(__file__), "goldens", "ref_trim.npz")
    )
    msa_file, _, biomolecule = TRIM_CASES[key + "_refseq"]
    tr = MSATrimmer(
        reference_file(msa_file), biomolecule=biomolecule, max_gap=max_gap
    )
    cols = np.asarray(tr.trim_by_gap_size(), np.int32)
    np.testing.assert_array_equal(cols, golden[f"{key}_gap{int(max_gap*100)}_cols"])
