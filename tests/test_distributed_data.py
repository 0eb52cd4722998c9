"""Host-local FASTA sharding + global dedup (multi-host data loading).

Runs single-process: the multi-process layout is simulated by invoking the
loader once per simulated process id and checking the union reproduces the
single-host reader exactly (same dedup semantics, same rows).
"""

import numpy as np
import pytest

from pydca_tpu import read_msa
from pydca_tpu.parallel.data import (
    _row_hashes,
    global_dedup_keep,
    load_local_shard,
    read_msa_distributed,
    weights_distributed,
)


def _write_fasta(path, rows, letters="ACGU-", start=0):
    with open(path, "w") as fh:
        for k, r in enumerate(rows):
            fh.write(f">s{start + k}\n" + "".join(letters[int(x)] for x in r) + "\n")


@pytest.fixture()
def msa_with_dups(tmp_path):
    rng = np.random.default_rng(11)
    base = rng.integers(0, 5, size=(6, 20))
    rows = base[rng.integers(0, 6, size=120)]  # many duplicates
    mut = rng.random(rows.shape) < 0.1
    rows = np.where(mut, rng.integers(0, 5, size=rows.shape), rows)
    path = str(tmp_path / "dups.fa")
    _write_fasta(path, rows)
    return path, rows


def _simulate(files, nproc, biomolecule="rna"):
    """Run the distributed loader once per simulated process; emulate the
    hash all-gather by pooling every shard's hashes."""
    shards = [load_local_shard(files, biomolecule, p, nproc) for p in range(nproc)]
    all_h = np.concatenate([_row_hashes(s.data) for s in shards])
    all_i = np.concatenate([s.global_index for s in shards])
    kept = []
    for s in shards:
        keep = global_dedup_keep(_row_hashes(s.data), s.global_index, all_h, all_i)
        kept.append(s.data[keep])
    return shards, kept


@pytest.mark.parametrize("nproc", [1, 3, 4])
def test_striped_single_file_union_matches_reader(msa_with_dups, nproc):
    path, _ = msa_with_dups
    _, kept = _simulate(path, nproc)
    union = np.concatenate(kept, axis=0)
    ref = read_msa(path, "rna").data
    # same rows after global first-occurrence dedup (order differs by stripe)
    assert union.shape == ref.shape
    ref_set = {r.tobytes() for r in ref}
    uni_set = {r.tobytes() for r in union}
    assert uni_set == ref_set
    # no duplicate survived across processes
    assert len(uni_set) == union.shape[0]


def test_shard_files_union_matches_reader(tmp_path, msa_with_dups):
    _, rows = msa_with_dups
    # split the same records into 5 shard files
    files = []
    splits = np.array_split(np.arange(len(rows)), 5)
    for k, idx in enumerate(splits):
        f = str(tmp_path / f"shard{k}.fa")
        _write_fasta(f, rows[idx], start=int(idx[0]))
        files.append(f)
    whole = str(tmp_path / "whole.fa")
    _write_fasta(whole, rows)

    _, kept = _simulate(files, 3)
    union = np.concatenate([k for k in kept if k.size], axis=0)
    ref = read_msa(whole, "rna").data
    assert union.shape == ref.shape
    assert {r.tobytes() for r in union} == {r.tobytes() for r in ref}


def test_global_index_assignment_across_shard_files(tmp_path):
    rows = np.arange(12).reshape(6, 2) % 5
    files = []
    for k in range(3):
        f = str(tmp_path / f"p{k}.fa")
        _write_fasta(f, rows[2 * k : 2 * k + 2], start=2 * k)
        files.append(f)
    # process 1 of 2 owns files 1 (records 2,3); global indices must match
    shard = load_local_shard(files, "rna", 1, 2)
    np.testing.assert_array_equal(shard.global_index, [2, 3])


def test_read_msa_distributed_single_process_matches_reader(msa_with_dups):
    path, _ = msa_with_dups
    sharded = read_msa_distributed(path, "rna")
    ref = read_msa(path, "rna")
    assert sharded.global_num_seqs == ref.num_seqs
    assert sharded.local_valid.all()
    np.testing.assert_array_equal(sharded.local_data, ref.data)


def test_weights_distributed_pads_are_inert(msa_with_dups):
    """Weights over the assembled global array (with explicit pad rows) must
    match the plain single-device weights on the unpadded alignment."""
    import jax.numpy as jnp

    from pydca_tpu import stats
    from pydca_tpu.parallel import make_mesh
    from pydca_tpu.parallel.data import ShardedMSA

    path, _ = msa_with_dups
    ref = read_msa(path, "rna")
    n = ref.num_seqs
    npad = 6
    padded = np.concatenate(
        [ref.data, np.full((npad, ref.seqs_len), 4, np.int8)], axis=0
    )
    valid = np.concatenate([np.ones(n, bool), np.zeros(npad, bool)])
    sharded = ShardedMSA(
        local_data=padded,
        local_valid=valid,
        ids=list(ref.ids),
        q=ref.q,
        global_num_seqs=n,
        seqs_len=ref.seqs_len,
        num_processes=1,
    )
    mesh = make_mesh()
    msa_g, w, valid_g = weights_distributed(sharded, 0.8, mesh)
    w_ref = np.asarray(stats.sequence_weights(jnp.asarray(ref.data, jnp.int32), 0.8, ref.q))
    np.testing.assert_allclose(np.asarray(w)[:n], w_ref, rtol=1e-6)
    assert (np.asarray(w)[n:] == 0).all()


def test_distributed_weights_feed_sharded_fit(msa_with_dups):
    """End-to-end: distributed ingestion -> weights -> sharded plm fit equals
    the unsharded fit on the dedupped alignment."""
    import jax.numpy as jnp

    from pydca_tpu import stats
    from pydca_tpu.parallel import fit_plm_sharded, make_mesh
    from pydca_tpu.plm import fit_plm

    path, _ = msa_with_dups
    sharded = read_msa_distributed(path, "rna")
    mesh = make_mesh()
    msa_g, w, _ = weights_distributed(sharded, 0.8, mesh)
    l, q = sharded.seqs_len, sharded.q
    r_dist = fit_plm_sharded(
        np.asarray(msa_g), biomolecule_q=q, weights=w, max_iterations=8, mesh=mesh
    )

    ref = read_msa(path, "rna")
    w_ref = stats.sequence_weights(jnp.asarray(ref.data, jnp.int32), 0.8, q)
    lam = jnp.float32(0.2 * (l - 1))
    r_single = fit_plm(
        jnp.asarray(ref.data, jnp.int32), w_ref, lam, lam, l, q, max_iterations=8
    )
    np.testing.assert_allclose(float(r_dist.fx), float(r_single.fx), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(r_dist.x), np.asarray(r_single.x), rtol=2e-3, atol=2e-3
    )


# ---------------------------------------------------------------- r3 additions
class ThreadedAllgather:
    """Barrier-based all-gather for simulating P processes with P threads.

    Each simulated process calls its own closure; the closure blocks at a
    barrier until every process has deposited its array, then returns the
    full list — the same contract as the real multihost transport.
    """

    def __init__(self, nproc):
        import threading

        self.nproc = nproc
        self.barrier = threading.Barrier(nproc)
        self.slots = [None] * nproc

    def for_process(self, pid):
        def allgather(local):
            self.slots[pid] = local
            self.barrier.wait()
            out = list(self.slots)
            self.barrier.wait()  # don't overwrite slots before all have read
            return out

        return allgather


def _run_distributed_threads(files, nproc, **kwargs):
    from concurrent.futures import ThreadPoolExecutor

    ag = ThreadedAllgather(nproc)
    with ThreadPoolExecutor(nproc) as ex:
        futs = [
            ex.submit(
                read_msa_distributed,
                files,
                "rna",
                process_id=p,
                num_processes=nproc,
                allgather_fn=ag.for_process(p),
                **kwargs,
            )
            for p in range(nproc)
        ]
        return [f.result(timeout=60) for f in futs]


def test_zero_shard_process_gets_consistent_shapes(tmp_path, msa_with_dups):
    """ADVICE r2 (medium): 2 shard files, 4 processes — processes 2-3 own
    zero files but must still produce (n_pad, L) padded data and join the
    collectives."""
    _, rows = msa_with_dups
    files = []
    for k, idx in enumerate(np.array_split(np.arange(len(rows)), 2)):
        f = str(tmp_path / f"z{k}.fa")
        _write_fasta(f, rows[idx], start=int(idx[0]))
        files.append(f)

    shards = _run_distributed_threads(files, 4)
    l = shards[0].seqs_len
    assert l == rows.shape[1]
    for s in shards:
        assert s.seqs_len == l
        assert s.local_data.shape == (shards[0].local_data.shape[0], l)
        assert s.local_data.shape[0] >= 0
    # zero-owners contribute only pad rows
    assert not shards[2].local_valid.any()
    assert not shards[3].local_valid.any()
    # union of valid rows == single-host reader after dedup
    union = np.concatenate(
        [s.local_data[s.local_valid] for s in shards], axis=0
    )
    whole = str(tmp_path / "whole_z.fa")
    _write_fasta(whole, rows)
    ref = read_msa(whole, "rna").data
    assert {r.tobytes() for r in union} == {r.tobytes() for r in ref}
    assert union.shape == ref.shape
    assert shards[0].global_num_seqs == ref.shape[0]


def test_owned_only_counting_matches_full_scan(tmp_path, msa_with_dups):
    """The nproc>1 path counts only owned files and all-gathers counts;
    results must match the single-process full-scan loader."""
    _, rows = msa_with_dups
    files = []
    for k, idx in enumerate(np.array_split(np.arange(len(rows)), 5)):
        f = str(tmp_path / f"c{k}.fa")
        _write_fasta(f, rows[idx], start=int(idx[0]))
        files.append(f)

    shards = _run_distributed_threads(files, 3)
    union = np.concatenate(
        [s.local_data[s.local_valid] for s in shards], axis=0
    )
    single = read_msa_distributed(files, "rna", process_id=0, num_processes=1)
    assert {r.tobytes() for r in union} == {
        r.tobytes() for r in single.local_data[single.local_valid]
    }


def test_file_counts_manifest_skips_scan(tmp_path):
    """Explicit file_counts must be honored (and validated during parse)."""
    rows = (np.arange(24).reshape(8, 3) % 5).astype(np.int8)
    files = []
    for k in range(4):
        f = str(tmp_path / f"m{k}.fa")
        _write_fasta(f, rows[2 * k : 2 * k + 2], start=2 * k)
        files.append(f)
    shard = load_local_shard(files, "rna", 1, 2, file_counts=[2, 2, 2, 2])
    np.testing.assert_array_equal(shard.global_index, [2, 3, 6, 7])
    with pytest.raises(ValueError):
        load_local_shard(files, "rna", 1, 2, file_counts=[2, 3, 2, 2])
    with pytest.raises(ValueError):
        load_local_shard(files, "rna", 1, 2, file_counts=[2, 2])


def test_simulation_without_allgather_raises(msa_with_dups):
    """nproc>1 in a single-process runtime without allgather_fn must raise
    the documented error, not IndexError (ADVICE r2)."""
    path, _ = msa_with_dups
    with pytest.raises(RuntimeError, match="allgather_fn"):
        read_msa_distributed(path, "rna", process_id=0, num_processes=2)
