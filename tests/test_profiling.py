"""Stage timers and the engines' instrumentation."""

import numpy as np

from pydca_tpu.alphabets import RNA
from pydca_tpu.io.fasta import MSA
from pydca_tpu.meanfield import MeanFieldDCA
from pydca_tpu.profiling import StageTimers, device_trace


def test_stage_timers_accumulate_and_rates():
    t = StageTimers()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    t.add_rate("a", 100, "iters")
    assert t.elapsed("a") >= 0
    assert t.total >= t.elapsed("a")
    s = t.summary()
    assert "a" in s and "b" in s and "total" in s and "iters/s" in s


def test_device_trace_noop():
    with device_trace(None):
        pass


def test_engine_timers_populated():
    rng = np.random.default_rng(0)
    msa = MSA(data=rng.integers(0, 5, (30, 9)).astype(np.int8), alphabet=RNA)
    inst = MeanFieldDCA(msa, "rna")
    inst.compute_sorted_FN_APC()
    # the FN path runs as one fused device program
    assert inst.timers.elapsed("pipeline") > 0
    # the staged weights path still records its own stage
    inst2 = MeanFieldDCA(msa, "rna")
    inst2.get_sequences_weight()
    assert inst2.timers.elapsed("weights") > 0


def test_device_trace_raises_when_trace_cannot_start(tmp_path):
    """A trace that was asked for and cannot start is an error, not a
    silent no-op: JAX runs one profiler session at a time."""
    import pytest

    with device_trace(str(tmp_path / "outer")):
        with pytest.raises(RuntimeError):
            with device_trace(str(tmp_path / "inner")):
                pass
    assert any((tmp_path / "outer").rglob("*.xplane.pb"))
