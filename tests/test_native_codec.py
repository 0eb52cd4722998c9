"""Native FASTA codec must agree with the Python reader exactly."""

import numpy as np
import pytest

from pydca_tpu.alphabets import PROTEIN, RNA
from pydca_tpu.io import fasta as fasta_mod
from pydca_tpu.native import fastacodec

from conftest import reference_file

pytestmark = pytest.mark.skipif(
    not fastacodec.available(), reason="no C++ toolchain for the native codec"
)


def _python_read(path, biomolecule):
    ids, seqs = fasta_mod.read_sequences(path)
    alph = RNA if biomolecule == "rna" else PROTEIN
    data = alph.encode_many(seqs)
    return fasta_mod._dedup_encoded(data, ids)


@pytest.mark.parametrize(
    "name,biomolecule",
    [("rf00167", "rna"), ("pf02826", "protein"), ("rf00059", "rna")],
)
def test_native_matches_python(name, biomolecule):
    path = reference_file(name)
    alph = RNA if biomolecule == "rna" else PROTEIN
    data_n, ids_n = fastacodec.read_and_encode(path, alph, dedup=True)
    data_p, ids_p = _python_read(path, biomolecule)
    assert data_n.shape == data_p.shape
    np.testing.assert_array_equal(data_n, data_p)
    assert ids_n == ids_p


def test_native_wrapped_lines_and_comments(tmp_path):
    f = tmp_path / "wrapped.fa"
    f.write_text(
        ">s1 desc here\nACG\nU-\n; a comment\n>s2\nacgu-\n\n>s2dup\nACGU-\n"
    )
    data, ids = fastacodec.read_and_encode(str(f), RNA, dedup=True)
    assert data.shape == (1, 5)  # s2/s2dup identical to s1 after encoding
    assert ids == ["s1 desc here"]
    np.testing.assert_array_equal(data[0], [0, 1, 2, 3, 4])
    data2, ids2 = fastacodec.read_and_encode(str(f), RNA, dedup=False)
    assert data2.shape == (3, 5)


def test_native_error_paths(tmp_path):
    from pydca_tpu.io.fasta import FastaError

    bad = tmp_path / "bad.fa"
    bad.write_text("ACGU\n>late\nACGU\n")
    with pytest.raises(FastaError):
        fastacodec.read_and_encode(str(bad), RNA)
    uneq = tmp_path / "uneq.fa"
    uneq.write_text(">a\nACGU\n>b\nACG\n")
    with pytest.raises(FastaError):
        fastacodec.read_and_encode(str(uneq), RNA)
    with pytest.raises(FastaError):
        fastacodec.read_and_encode(str(tmp_path / "missing.fa"), RNA)


def test_read_msa_uses_native(tmp_path):
    msa = fasta_mod.read_msa(reference_file("rf00167"), "rna")
    assert msa.num_seqs == 2544  # deduplicated count
    assert msa.seqs_len == 102
