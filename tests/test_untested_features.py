"""Coverage for shipped-but-previously-untested features (round-1 VERDICT #5):

- checkpoint/resume roundtrip of the plm optimizer state (bitwise match
  against an uninterrupted run);
- ``mm_bf16`` ranking preservation on RF00167 (slow);
- persistent compilation-cache configuration smoke;
- CLI ``--refseq_file`` backmapped scoring end-to-end.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pydca_tpu import stats
from pydca_tpu.plm import fit_plm

from conftest import reference_file


def _toy(n=80, l=14, q=5, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, q, (4, l))
    msa = base[rng.integers(0, 4, n)]
    mut = rng.random((n, l)) < 0.25
    return np.where(mut, rng.integers(0, q, (n, l)), msa).astype(np.int32)


# --------------------------------------------------------- checkpoint/resume
class TestCheckpointResume:
    def _fit(self, msa, w, lam, l, q, iters, ckpt=None):
        return fit_plm(
            jnp.asarray(msa), w, lam, lam, l, q,
            max_iterations=iters, chunk_size=5,
            checkpoint_path=ckpt, checkpoint_every=5,
        )

    def test_interrupted_resume_matches_uninterrupted_bitwise(self, tmp_path):
        msa = _toy()
        l, q = msa.shape[1], 5
        lam = jnp.float32(0.2 * (l - 1))
        w = stats.sequence_weights(jnp.asarray(msa), 0.8, q)

        full = self._fit(msa, w, lam, l, q, 20)

        # "kill" at iteration 10: run a 10-iteration budget that saves its
        # state, then a fresh 20-iteration call that must resume from it
        ckpt = str(tmp_path / "state")
        part = self._fit(msa, w, lam, l, q, 10, ckpt=ckpt)
        assert os.path.exists(ckpt + ".npz"), "checkpoint file not written"
        assert int(part.num_iters) <= 10
        resumed = self._fit(msa, w, lam, l, q, 20, ckpt=ckpt)

        assert int(resumed.num_iters) == int(full.num_iters)
        np.testing.assert_array_equal(np.asarray(resumed.x), np.asarray(full.x))
        np.testing.assert_array_equal(
            np.asarray(resumed.fx), np.asarray(full.fx)
        )

    def test_checkpoint_roundtrip_preserves_state(self, tmp_path):
        from pydca_tpu.plm import _load_state, _save_state, _plm_lbfgs_state0

        msa = _toy(seed=8)
        l, q = msa.shape[1], 5
        lam = jnp.float32(0.2 * (l - 1))
        w = stats.sequence_weights(jnp.asarray(msa), 0.8, q)
        pidx = jnp.asarray(stats.pair_index_matrix(l))
        state = _plm_lbfgs_state0(
            jnp.asarray(msa), w, pidx, lam, lam, l, q, 5
        )
        path = str(tmp_path / "st.npz")
        _save_state(path, state)
        loaded = _load_state(path)
        for name in state._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(state, name)),
                np.asarray(getattr(loaded, name)),
                err_msg=name,
            )


# ------------------------------------------------------------------ mm_bf16
def test_mm_bf16_preserves_rankings_toy():
    """bf16 logits matmul must preserve FN score rankings (fast, toy)."""
    from pydca_tpu import score as score_mod

    msa = _toy(n=120, l=16, q=5, seed=9)
    l, q = msa.shape[1], 5
    lam = jnp.float32(0.2 * (l - 1))
    w = stats.sequence_weights(jnp.asarray(msa), 0.8, q)
    r32 = fit_plm(jnp.asarray(msa), w, lam, lam, l, q, max_iterations=30)
    r16 = fit_plm(
        jnp.asarray(msa), w, lam, lam, l, q, max_iterations=30, mm_bf16=True
    )

    def fn_apc(params):
        p = l * (l - 1) // 2
        blocks = np.asarray(params)[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]
        fn = np.asarray(score_mod.frobenius_norms(jnp.asarray(blocks)))
        return np.asarray(score_mod.apc(jnp.asarray(fn), l))

    a, b = fn_apc(r32.x), fn_apc(r16.x)
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    rho = (ra * rb).sum() / np.sqrt((ra**2).sum() * (rb**2).sum())
    assert rho >= 0.95, f"bf16 fit broke rankings: spearman {rho:.4f}"


@pytest.mark.slow
def test_mm_bf16_preserves_rankings_rf00167():
    """bf16 fit on RF00167 must rank-match the reference backend's params."""
    from pydca_tpu import read_msa
    from pydca_tpu import score as score_mod

    golden = np.load(
        os.path.join(os.path.dirname(__file__), "goldens", "ref_plm_rf00167_it100.npz")
    )
    msa = read_msa(reference_file("rf00167"), "rna")
    l, q = msa.seqs_len, msa.q
    m = jnp.asarray(msa.data, jnp.int32)
    w = stats.sequence_weights(m, 0.8, q)
    lam = jnp.float32(0.2 * (l - 1))
    r16 = fit_plm(m, w, lam, lam, l, q, max_iterations=100, mm_bf16=True)

    def fn_apc(params):
        p = l * (l - 1) // 2
        blocks = np.asarray(params)[l * q :].reshape(p, q, q)[:, : q - 1, : q - 1]
        fn = np.asarray(score_mod.frobenius_norms(jnp.asarray(blocks)))
        return np.asarray(score_mod.apc(jnp.asarray(fn), l))

    ours, ref = fn_apc(r16.x), fn_apc(golden["params"])
    ra = np.argsort(np.argsort(ours)).astype(float)
    rb = np.argsort(np.argsort(ref)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    rho = (ra * rb).sum() / np.sqrt((ra**2).sum() * (rb**2).sum())
    assert rho >= 0.97, f"spearman {rho:.4f}"
    top = lambda x: set(np.argsort(-x)[:20].tolist())  # noqa: E731
    assert len(top(ours) & top(ref)) >= 18


# ------------------------------------------------------- compilation cache
@pytest.fixture
def jax_cache_config():
    """Restore JAX's cache settings after a test that changes them."""
    names = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    old = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in old.items():
        jax.config.update(n, v)


def test_enable_compilation_cache_uses_env_dir(tmp_path, monkeypatch,
                                               jax_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set the cache lands there and the code
    sets no directory of its own (JAX reads the variable itself)."""
    from pydca_tpu import runtime

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compilation_cache() == env_dir
    assert os.path.isdir(env_dir)
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0


def test_enable_compilation_cache_fixed_checkout_path(monkeypatch,
                                                      jax_cache_config):
    """Without the variable the cache is .jax_cache/ at the checkout root —
    a fixed path, because the path is part of every cache key."""
    from pydca_tpu import runtime

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert runtime.cache_dir() == want
    assert runtime.enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_enable_compilation_cache_cpu_noop(tmp_path, monkeypatch,
                                           jax_cache_config):
    from pydca_tpu import runtime

    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    env_dir = tmp_path / "never"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(env_dir))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
    assert not env_dir.exists()


# ------------------------------------------------- CLI --refseq_file path
@pytest.mark.slow
def test_mfdca_cli_refseq_backmapped(tmp_path):
    from pydca_tpu.cli.mfdca_main import run_meanfield_dca

    out = str(tmp_path / "out")
    run_meanfield_dca(
        [
            "compute_fn", "rna", reference_file("rf00167"), "--apc",
            "--refseq_file", reference_file("rf00167_ref"),
            "--output_dir", out,
        ]
    )
    files = [f for f in os.listdir(out) if f.startswith("MFDCA_apc_fn_scores")]
    assert len(files) == 1
    pairs = []
    with open(os.path.join(out, files[0])) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            i, j, s = line.split()
            pairs.append((int(i), int(j), float(s)))
    # refseq RF00167 is 71 nt: backmapped output must cover exactly the
    # refseq pair universe, 1-indexed, descending
    assert len(pairs) == 71 * 70 // 2
    for i, j, _ in pairs:
        assert 1 <= i < j <= 71
    vals = [s for _, _, s in pairs]
    assert vals == sorted(vals, reverse=True)
