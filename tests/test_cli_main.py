"""pydca top-level CLI smoke tests (trim + visualizer commands)."""

import os

import pytest

from pydca_tpu.cli.main import run_pydca

from conftest import reference_file


def test_trim_by_gap_size(tmp_path):
    out = str(tmp_path / "trimout")
    run_pydca(
        ["trim_by_gap_size", reference_file("rf00059"), "--max_gap", "0.4", "--output_dir", out]
    )
    files = os.listdir(out)
    assert files == ["Trimmed_MSA_RF00059_trimmed_gap_treshold_50.fa"]
    with open(os.path.join(out, files[0])) as fh:
        first = fh.readline()
        assert first.startswith(">")


def test_trim_by_refseq(tmp_path):
    out = str(tmp_path / "trimref")
    run_pydca(
        [
            "trim_by_refseq", "rna", reference_file("rf00059"),
            reference_file("rf00059_ref"),
            "--remove_all_gaps", "--output_dir", out,
        ]
    )
    files = os.listdir(out)
    assert len(files) == 1
    # all sequences same trimmed length
    lengths = set()
    with open(os.path.join(out, files[0])) as fh:
        for line in fh:
            if not line.startswith(">"):
                lengths.add(len(line.strip()))
    assert len(lengths) == 1


def test_plot_commands(tmp_path, monkeypatch):
    # build the synthetic PDB fixture inline (same as test_eval)
    from test_eval import _pdb_atom_line

    refseq = "ACGUAC"
    pdb_res = ["A", "C", "U", "A", "C"]
    positions = {
        0: (0.0, 0.0, 0.0),
        1: (10.0, 0.0, 0.0),
        2: (20.0, 0.0, 0.0),
        3: (10.0, 3.0, 0.0),
        4: (0.0, 3.0, 0.0),
    }
    lines, serial = [], 1
    for k, resname in enumerate(pdb_res):
        x, y, z = positions[k]
        lines.append(_pdb_atom_line(serial, "P", resname, "X", k + 1, x, y, z, "P"))
        serial += 1
    pdb = tmp_path / "toy.pdb"
    pdb.write_text("".join(lines) + "END\n")
    ref = tmp_path / "ref.fa"
    ref.write_text(f">r\n{refseq}\n")
    dca = tmp_path / "dca.txt"
    dca.write_text("1 6 3.5\n2 5 3.0\n1 4 2.0\n")

    out = str(tmp_path / "cm")
    run_pydca(
        [
            "plot_contact_map", "rna", "X", str(pdb), str(ref), str(dca),
            "--linear_dist", "2", "--num_dca_contacts", "2",
            "--output_dir", out, "--no_show",
        ]
    )
    files = sorted(os.listdir(out))
    assert "contact_maptoy.txt" in files
    assert "contact_map_toy.png" in files

    out2 = str(tmp_path / "tpr")
    run_pydca(
        [
            "plot_tp_rate", "rna", "X", str(pdb), str(ref), str(dca),
            "--linear_dist", "2", "--output_dir", out2, "--no_show",
        ]
    )
    files2 = sorted(os.listdir(out2))
    assert "TPR_toy.txt" in files2


def test_pdb_content(tmp_path, capsys):
    from test_eval import _pdb_atom_line

    pdb = tmp_path / "c.pdb"
    pdb.write_text(
        _pdb_atom_line(1, "P", "A", "X", 1, 0, 0, 0, "P")
        + _pdb_atom_line(2, "P", "C", "X", 2, 5, 0, 0, "P")
        + "END\n"
    )
    run_pydca(["pdb_content", str(pdb)])
    out = capsys.readouterr().out
    assert "chain X [RNA] (2 residues): AC" in out
