"""The backend query, the device-memory budgets and the seeded alignments."""

import jax
import numpy as np
import pytest

from pydca_tpu import runtime
from pydca_tpu.plm import STREAM_CPU_BYTES, auto_seq_block


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_backend_answers_gpu_or_cpu(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert runtime.backend() == platform


def test_backend_refuses_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        runtime.backend()


class _Dev:
    device_kind = "test card"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_memory_budget_is_a_share_of_the_device(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda: [_Dev({"bytes_limit": 64 << 30})])
    assert runtime.memory_budget(1 / 16, 123) == 4 << 30


def test_memory_budget_raises_without_a_device_limit(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda: [_Dev({})])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        runtime.memory_budget(1 / 16, 123)


def test_memory_budget_keeps_cpu_constants():
    assert runtime.memory_budget(1 / 16, 123) == 123


@pytest.mark.parametrize(
    "n,expect_stream", [(1000, False), (STREAM_CPU_BYTES // (4 * 120 * 5) + 1, True)]
)
def test_auto_seq_block_streams_past_the_budget(n, expect_stream):
    block = auto_seq_block(n, 120, 5)
    if not expect_stream:
        assert block is None
    else:
        assert block >= 1024 and 4 * block * 120 * 5 <= STREAM_CPU_BYTES


def test_dryrun_multichip_refuses_too_few_devices():
    import __graft_entry__

    with pytest.raises(RuntimeError, match="sees only"):
        __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)


def test_planted_alignment_copies_the_planted_columns():
    from pydca_tpu.synthetic import planted_alignment

    codes, pairs = planted_alignment(4000, 60, 21, 8, seed=3, relatives=0.0)
    assert len(pairs) == 8 and len({c for p in pairs for c in p}) == 16
    for i, j in pairs:
        assert abs(i - j) > 4
        # the most frequent state of j given each state of i carries ~0.8
        joint = np.zeros((21, 21))
        np.add.at(joint, (codes[:, i], codes[:, j]), 1)
        assert joint.max(axis=1).sum() / len(codes) > 0.75


def test_clustered_codes_have_real_neighbours():
    from pydca_tpu import stats
    from pydca_tpu.synthetic import clustered_codes

    codes = clustered_codes(600, 40, 5, seed=1, clusters=8)
    w = np.asarray(stats.sequence_weights(jax.numpy.asarray(codes), 0.8, 5))
    counts = np.rint(1 / w)
    assert counts.min() >= 1 and counts.mean() > 2


def test_card_reads_the_first_nvidia_smi_line(monkeypatch):
    import subprocess

    seen = []

    def fake_run(cmd, **kwargs):
        seen.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout="Card A, 700.00 W\nCard B, 700.00 W\n"
        )

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert runtime.card() == "Card A, 700.00 W"
    assert seen[0][1:] == [
        "--query-gpu=name,power.limit", "--format=csv,noheader"
    ]


def test_require_gpu_refuses_a_machine_without_cuda():
    """No quiet CPU fallback: the process fails instead of running on the
    CPU (in a fresh process, as the check must precede every backend)."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where one exists
    proc = subprocess.run(
        [sys.executable, "-c",
         "from pydca_tpu import runtime; runtime.require_gpu(); print('ran')"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "ran" not in proc.stdout


@pytest.mark.parametrize("mesh,data", [("auto", "all"), (None, None)])
def test_plmdca_exposes_its_resolved_mesh(mesh, data):
    from pydca_tpu.alphabets import RNA
    from pydca_tpu.io.fasta import MSA
    from pydca_tpu.plm import PlmDCA
    from pydca_tpu.synthetic import clustered_codes

    msa = MSA(data=clustered_codes(32, 6, 5, seed=0), alphabet=RNA)
    inst = PlmDCA(msa, "rna", mesh=mesh)
    if data is None:
        assert inst.mesh is None
    else:
        assert inst.mesh.shape["data"] == len(jax.devices()) > 1
