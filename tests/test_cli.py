"""CLI smoke tests: commands write reference-format output files."""

import os

import numpy as np
import pytest

from pydca_tpu.cli.mfdca_main import run_meanfield_dca
from pydca_tpu.cli.plmdca_main import run_plm_dca


@pytest.fixture()
def tiny_msa(tmp_path):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 5, size=(3, 12))
    rows = base[rng.integers(0, 3, size=40)]
    mut = rng.random(rows.shape) < 0.3
    rows = np.where(mut, rng.integers(0, 5, size=rows.shape), rows)
    letters = "ACGU-"
    path = tmp_path / "tiny.fa"
    with open(path, "w") as fh:
        for k, r in enumerate(rows):
            fh.write(f">s{k}\n" + "".join(letters[int(x)] for x in r) + "\n")
    return str(path)


def _read_scores(path):
    pairs = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            i, j, s = line.split()
            pairs.append(((int(i), int(j)), float(s)))
    return pairs


def test_mfdca_compute_fn_apc(tiny_msa, tmp_path):
    out = str(tmp_path / "out")
    run_meanfield_dca(
        ["compute_fn", "rna", tiny_msa, "--apc", "--output_dir", out]
    )
    files = os.listdir(out)
    assert files == ["MFDCA_apc_fn_scores_tiny.txt"]
    scores = _read_scores(os.path.join(out, files[0]))
    assert len(scores) == 12 * 11 // 2
    # 1-indexed, i < j, descending
    for (i, j), _ in scores:
        assert 1 <= i < j <= 12
    vals = [s for _, s in scores]
    assert vals == sorted(vals, reverse=True)


def test_mfdca_compute_di_and_freqs(tiny_msa, tmp_path):
    out = str(tmp_path / "out2")
    run_meanfield_dca(["compute_di", "rna", tiny_msa, "--output_dir", out])
    run_meanfield_dca(["compute_fi", "rna", tiny_msa, "--output_dir", out])
    run_meanfield_dca(["compute_fij", "rna", tiny_msa, "--output_dir", out])
    run_meanfield_dca(["compute_params", "rna", tiny_msa, "--output_dir", out,
                       "--linear_dist", "2"])
    names = sorted(os.listdir(out))
    assert names == [
        "MFDCA_raw_di_scores_tiny.txt",
        "couplings_tiny.txt",
        "fi_tiny.txt",
        "fields_tiny.txt",
        "fij_tiny.txt",
    ]
    # fi file: L*q rows of i,a,freq
    rows = [
        line for line in open(os.path.join(out, "fi_tiny.txt"))
        if not line.startswith("#")
    ]
    assert len(rows) == 12 * 5


def test_plmdca_compute_fn_apc(tiny_msa, tmp_path):
    out = str(tmp_path / "out3")
    run_plm_dca(
        [
            "compute_fn", "rna", tiny_msa, "--apc", "--output_dir", out,
            "--max_iterations", "25",
        ]
    )
    files = os.listdir(out)
    assert files == ["PLMDCA_apc_fn_scores_tiny.txt"]
    scores = _read_scores(os.path.join(out, files[0]))
    assert len(scores) == 12 * 11 // 2


def test_plmdca_precision_and_checkpoint_flags(tiny_msa, tmp_path):
    """--precision and --checkpoint are wired through to the engine."""
    out = str(tmp_path / "out4")
    ckpt = str(tmp_path / "ck" / "state.npz")
    run_plm_dca(
        [
            "compute_fn", "rna", tiny_msa, "--apc", "--output_dir", out,
            "--max_iterations", "30", "--precision", "float32",
            "--checkpoint", ckpt,
        ]
    )
    assert os.path.exists(ckpt)
    first = _read_scores(os.path.join(out, "PLMDCA_apc_fn_scores_tiny.txt"))
    # resume from the finished checkpoint: runs 0 extra iterations and
    # reproduces the same scores
    out2 = str(tmp_path / "out5")
    run_plm_dca(
        [
            "compute_fn", "rna", tiny_msa, "--apc", "--output_dir", out2,
            "--max_iterations", "30", "--precision", "float32",
            "--checkpoint", ckpt,
        ]
    )
    second = _read_scores(os.path.join(out2, "PLMDCA_apc_fn_scores_tiny.txt"))
    assert first == second


def test_plmdca_precision_rejects_garbage(tiny_msa, tmp_path):
    from pydca_tpu.plm import PlmDCA, PlmDCAException

    with pytest.raises(PlmDCAException):
        PlmDCA(tiny_msa, "rna", precision="float16")


def test_mfdca_compute_weights(tiny_msa, tmp_path):
    out = str(tmp_path / "outw")
    run_meanfield_dca(["compute_weights", "rna", tiny_msa, "--output_dir", out])
    files = os.listdir(out)
    assert files == ["weights_tiny.txt"]
    rows = [
        line.strip().split(",")
        for line in open(os.path.join(out, files[0]))
        if not line.startswith("#")
    ]
    # 1-indexed, one row per (deduplicated) sequence, weights in (0, 1]
    assert int(rows[0][0]) == 1
    ws = [float(r[1]) for r in rows]
    assert all(0 < w <= 1 for w in ws)
    # Meff in the header equals the sum of the dumped weights
    header = [
        line for line in open(os.path.join(out, files[0]))
        if "Effective number" in line
    ][0]
    meff = float(header.split(":")[1])
    assert abs(sum(ws) - meff) < 1e-3


def test_plmdca_compute_fn_batch(tmp_path):
    """Family batch: N MSAs -> one vmapped fit -> per-family score files."""
    rng = np.random.default_rng(17)
    letters = "ACGU-"
    files = []
    for f in range(3):
        l = int(rng.integers(8, 13))
        base = rng.integers(0, 5, size=(3, l))
        rows = base[rng.integers(0, 3, size=30)]
        mut = rng.random(rows.shape) < 0.2
        rows = np.where(mut, rng.integers(0, 5, size=rows.shape), rows)
        p = tmp_path / f"fam{f}.fa"
        with open(p, "w") as fh:
            for k, r in enumerate(rows):
                fh.write(f">s{k}\n" + "".join(letters[int(x)] for x in r) + "\n")
        files.append((str(p), l))
    out = str(tmp_path / "batch_out")
    run_plm_dca(
        ["compute_fn_batch", "rna"]
        + [f for f, _ in files]
        + ["--apc", "--output_dir", out, "--max_iterations", "15"]
    )
    names = sorted(os.listdir(out))
    assert names == [f"PLMDCA_apc_fn_scores_fam{f}.txt" for f in range(3)]
    for (path, l), name in zip(files, names):
        scores = _read_scores(os.path.join(out, name))
        assert len(scores) == l * (l - 1) // 2
        for (i, j), _ in scores:
            assert 1 <= i < j <= l


def test_engines_auto_mesh_uses_all_test_devices(tiny_msa):
    """mesh='auto' on the 8-device CPU test mesh: sharded path, same
    rankings as single-device."""
    import jax
    from pydca_tpu.meanfield import MeanFieldDCA
    from pydca_tpu.plm import PlmDCA

    assert jax.device_count() == 8  # conftest virtual mesh

    a = MeanFieldDCA(tiny_msa, "rna")
    b = MeanFieldDCA(tiny_msa, "rna", mesh="auto")
    sa = a.compute_sorted_FN_APC()
    sb = b.compute_sorted_FN_APC()
    assert [p for p, _ in sa] == [p for p, _ in sb]
    ranked_a = np.array([s for _, s in sa])
    ranked_b = np.array([s for _, s in sb])
    np.testing.assert_allclose(ranked_a, ranked_b, rtol=1e-4, atol=1e-5)
    # the sharded couplings really are distributed over the mesh
    assert len(b.compute_couplings().sharding.device_set) == 8

    pa = PlmDCA(tiny_msa, "rna", max_iterations=10, precision="float32")
    pb = PlmDCA(
        tiny_msa, "rna", max_iterations=10, precision="float32", mesh="auto"
    )
    fa = pa.compute_sorted_FN_APC()
    fb = pb.compute_sorted_FN_APC()
    assert [p for p, _ in fa[:20]] == [p for p, _ in fb[:20]]


def test_mfdca_compute_fn_batch(tmp_path):
    rng = np.random.default_rng(23)
    letters = "ACGU-"
    files, lens = [], []
    for f in range(2):
        l = int(rng.integers(8, 12))
        rows = rng.integers(0, 5, size=(25, l))
        p = tmp_path / f"mfam{f}.fa"
        with open(p, "w") as fh:
            for k, r in enumerate(rows):
                fh.write(f">s{k}\n" + "".join(letters[int(x)] for x in r) + "\n")
        files.append(str(p))
        lens.append(l)
    out = str(tmp_path / "mf_batch_out")
    run_meanfield_dca(
        ["compute_fn_batch", "rna"] + files + ["--apc", "--output_dir", out]
    )
    names = sorted(os.listdir(out))
    assert names == [f"MFDCA_apc_fn_scores_mfam{f}.txt" for f in range(2)]
    for l, name in zip(lens, names):
        scores = _read_scores(os.path.join(out, name))
        assert len(scores) == l * (l - 1) // 2


def test_warmup_functions_compile():
    """warmup_* AOT-compile the engine programs for given shapes without
    executing (VERDICT r3 item 3); both the full-batch and the
    auto-streaming plm variants must lower cleanly."""
    from pydca_tpu.warmup import warmup_meanfield, warmup_plm

    assert warmup_meanfield(60, 10, 5) >= 0.0
    assert warmup_plm(60, 10, 5, max_iterations=7, chunk_size=3) >= 0.0
    # explicit streaming shape
    assert warmup_plm(60, 10, 5, max_iterations=4, seq_block=16) >= 0.0


def test_cli_warmup_subcommands(tmp_path, monkeypatch):
    """mfdca/plmdca warmup run end-to-end from the CLI surface."""
    import io
    from contextlib import redirect_stdout

    from pydca_tpu.cli.mfdca_main import run_meanfield_dca
    from pydca_tpu.cli.plmdca_main import run_plm_dca

    from pydca_tpu.synthetic import planted_alignment, write_fasta

    monkeypatch.chdir(tmp_path)
    msa = str(tmp_path / "planted.fa")
    write_fasta(msa, planted_alignment(120, 24, 5, 3, seed=0)[0], "rna")
    buf = io.StringIO()
    with redirect_stdout(buf):
        run_meanfield_dca(["warmup", "rna", msa])
    assert "warmed mfDCA cache" in buf.getvalue()
    buf = io.StringIO()
    with redirect_stdout(buf):
        run_plm_dca(["warmup", "rna", msa, "--max_iterations", "10"])
    assert "warmed plmDCA cache" in buf.getvalue()


def test_warmup_traces_exactly_what_fit_traces(tmp_path):
    """Anti-drift guard (review r4): warmup AOT-compiles by MIRRORING the
    engine's dispatch decisions (weights block size, chunk todo set,
    param-space/streaming thresholds).  Enable a persistent compile cache,
    warm, then run the real fit: the heavy programs must all be cache
    hits, i.e. produce NO new cache entries.  If any mirrored decision
    drifts from the engine, the fit traces a different program and this
    fails."""
    import os

    import jax
    import jax.numpy as jnp

    from pydca_tpu import stats
    from pydca_tpu.plm import fit_plm
    from pydca_tpu.warmup import warmup_meanfield, warmup_plm
    from pydca_tpu.meanfield import _mf_fused_pipeline

    cache = tmp_path / "xla_cache"
    cache.mkdir()
    jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.02)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # the cache object is a process singleton: re-point it at this test's dir
    from jax._src import compilation_cache as _cc
    _cc.reset_cache()
    try:
        rng = np.random.default_rng(17)
        n, l, q = 120, 14, 5
        msa = jnp.asarray(rng.integers(0, q, (n, l)), jnp.int32)

        warmup_plm(n, l, q, max_iterations=9, chunk_size=4)
        warmup_meanfield(n, l, q)
        warmed = set(os.listdir(cache))
        assert warmed, "warmup produced no cache entries"

        w = stats.sequence_weights(msa, 0.8, q, dtype=jnp.float32)
        lam = jnp.float32(0.2 * (l - 1))
        fit_plm(msa, w, lam, lam, l, q, max_iterations=9, chunk_size=4)
        _mf_fused_pipeline(msa, l, q, 0.8, 0.5, jnp.float32)

        new = sorted(set(os.listdir(cache)) - warmed)
        # the engine may compile tiny eager helpers; the big engine
        # programs (weights scan, fused/generic L-BFGS programs, one-hot
        # prep, fused mf pipeline) must NOT appear as new entries
        heavy = [
            f for f in new
            if any(k in f for k in (
                "_sequence_weights_impl", "_plm_lbfgs", "_plm_fused",
                "_prep_msa", "_mf_fused_pipeline",
            ))
        ]
        assert not heavy, f"engine recompiled warmed programs: {heavy}"
    finally:
        jax.config.update("jax_compilation_cache_dir", None)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _cc.reset_cache()


def test_warmup_covers_mesh_auto(tmp_path):
    """r5 (VERDICT r4 item 4): warmup with a mesh AOT-compiles the
    GSPMD-sharded executables — a subsequent sharded run (the CLIs'
    ``--mesh auto`` default on multi-chip hosts) must be a pure cache hit
    for every heavy program.  Previously warmup only covered single-device
    programs and WARNED multi-chip users to run ``--mesh single``."""
    import os

    import jax
    import jax.numpy as jnp

    from pydca_tpu.parallel import fit_plm_sharded, make_mesh, mfdca_sharded
    from pydca_tpu.warmup import warmup_meanfield, warmup_plm

    cache = tmp_path / "xla_cache"
    cache.mkdir()
    jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.02)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # the cache object is a process singleton: re-point it at this test's dir
    from jax._src import compilation_cache as _cc
    _cc.reset_cache()
    try:
        rng = np.random.default_rng(23)
        n, l, q = 90, 12, 5  # n NOT divisible by 8: exercises pad mirroring
        msa = rng.integers(0, q, (n, l)).astype(np.int32)
        mesh = make_mesh()  # 8 virtual CPU devices, data axis

        warmup_plm(n, l, q, max_iterations=6, chunk_size=3, mesh=mesh)
        warmup_meanfield(n, l, q, mesh=mesh)
        warmed = set(os.listdir(cache))
        assert warmed, "mesh warmup produced no cache entries"

        warmup_plm(
            n, l, q, max_iterations=6, chunk_size=3, mesh=mesh, seq_block=16
        )
        warmed = set(os.listdir(cache)) | warmed

        fit_plm_sharded(
            msa, biomolecule_q=q, mesh=mesh, max_iterations=6, chunk_size=3
        )
        mfdca_sharded(msa, biomolecule_q=q, mesh=mesh)
        # streaming-on-the-mesh (generic loop) must hit the warmed sharded
        # programs too (review r5: its state spec used to drop shardings)
        fit_plm_sharded(
            msa, biomolecule_q=q, mesh=mesh, max_iterations=6, chunk_size=3,
            seq_block=16,
        )

        new = sorted(set(os.listdir(cache)) - warmed)
        heavy = [
            f for f in new
            if any(k in f for k in (
                "_sequence_weights_impl", "_plm_lbfgs", "_plm_fused",
                "_prep_msa", "_mf_fused_pipeline", "_mf_pipeline_sharded",
            ))
        ]
        assert not heavy, f"sharded run recompiled warmed programs: {heavy}"
    finally:
        jax.config.update("jax_compilation_cache_dir", None)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _cc.reset_cache()
