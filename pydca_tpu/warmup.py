"""Pre-warm the persistent XLA compilation cache for given problem shapes.

The CLI model is one command per process (reference: ``pydca/mfdca_main.py:299``
runs in seconds because Numba caches its JIT output on disk); here the first
process on a new shape pays the full XLA compile.
:func:`pydca_tpu.runtime.enable_compilation_cache` makes every
*subsequent* process load compiled executables in milliseconds — this module
fills that cache ahead of time.

Everything below uses AOT ``jit(...).lower(shapes).compile()``: the programs
are traced with the exact shapes/static-arguments/shardings the engines use
and compiled into the persistent cache WITHOUT executing (no device data, no
result fetch), so warming a large protein family costs compile time only.

Multi-chip (r5): ``mesh`` mirrors the CLIs' ``--mesh auto`` default.  The
GSPMD-sharded programs are lowered with ``ShapeDtypeStruct``s carrying the
same ``NamedSharding``s the engine's ``shard_msa`` placement produces, and
intermediate specs (one-hot, optimizer state) chain each compiled program's
``output_shardings`` into the next lower — so a subsequent ``--mesh auto``
run is a pure cache hit (previously warmup covered only the single-device
programs and told multi-chip users to run ``--mesh single``).

CLI: ``mfdca warmup <biomolecule> <msa>`` / ``plmdca warmup <biomolecule>
<msa> [--max_iterations ...]`` — reading the MSA pins the exact post-dedup
(N, L, q) the real run will trace with.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["warmup_meanfield", "warmup_plm"]


def _mesh_specs(mesh, n: int, l: int):
    """Mirror :func:`pydca_tpu.parallel.mesh.shard_msa`'s placement as
    ShapeDtypeStructs: padded N, data-sharded msa/weights, plus the valid
    mask of :func:`pydca_tpu.parallel.fit._weights_on_sharded`."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndata = int(mesh.shape["data"])
    n_tot = n + ((-n) % ndata)
    msa_spec = jax.ShapeDtypeStruct(
        (n_tot, l), jnp.int32, sharding=NamedSharding(mesh, P("data", None))
    )
    w_spec = jax.ShapeDtypeStruct(
        (n_tot,), jnp.float32, sharding=NamedSharding(mesh, P("data"))
    )
    valid_spec = jax.ShapeDtypeStruct(
        (n_tot,), jnp.bool_, sharding=NamedSharding(mesh, P("data"))
    )
    return n_tot, msa_spec, w_spec, valid_spec


def _weights_warmup(n: int, l: int, q: int, seqid: float, mesh=None) -> None:
    """Compile the sequence-weights program exactly as the engines dispatch
    it (:func:`pydca_tpu.stats.sequence_weights`: the identity-count kernel
    on the GPU, the blocked-XLA scan on the CPU; valid-masked on a mesh)."""
    import jax
    import jax.numpy as jnp

    from . import stats

    thr = float(seqid) * l
    if mesh is not None:
        n_tot, msa_spec, _, valid_spec = _mesh_specs(mesh, n, l)
        blk = min(2048, max(8, n_tot))
        with jax.set_mesh(mesh):
            if stats.identity_counts_path() == "kernel":
                stats._kernel_counts.lower(msa_spec, thr, q, valid_spec).compile()
            else:
                stats._sequence_weights_impl.lower(
                    msa_spec, jnp.float32(thr), q, blk, valid_spec,
                    has_valid=True,
                ).compile()
        return
    msa_spec = jax.ShapeDtypeStruct((n, l), jnp.int32)
    if stats.identity_counts_path() == "kernel":
        stats._kernel_counts.lower(msa_spec, thr, q).compile()
    else:
        blk = min(2048, max(8, n))
        stats._sequence_weights_impl.lower(
            msa_spec, jnp.float32(thr), q, blk
        ).compile()
    stats._counts_to_weights.lower(
        jax.ShapeDtypeStruct((n,), jnp.int32), jnp.float32
    ).compile()


def warmup_meanfield(
    n: int,
    l: int,
    q: int,
    *,
    seqid: float = 0.8,
    pseudocount: float = 0.5,
    mesh=None,
) -> float:
    """Compile the fused mfDCA pipeline for an (N, L, q) problem; returns
    seconds spent.  The next ``mfdca`` process on the same shapes starts
    cache-warm.  ``mesh``: ``None`` (single device), ``"auto"``, or a Mesh —
    mirrors the engine's ``--mesh`` dispatch."""
    import jax
    import jax.numpy as jnp

    from .meanfield import _mf_fused_pipeline, _resolve_mesh

    mesh = _resolve_mesh(mesh)
    t0 = time.perf_counter()
    if mesh is not None:
        from .parallel.fit import _mf_pipeline_sharded

        n_tot, msa_spec, w_spec, _ = _mesh_specs(mesh, n, l)
        shard_solve = int(mesh.shape.get("model", 1)) > 1 and l * (q - 1) > 4096
        with jax.set_mesh(mesh):
            _mf_pipeline_sharded.lower(
                msa_spec, w_spec, jnp.float32(pseudocount), l, q, shard_solve
            ).compile()
    else:
        msa_spec = jax.ShapeDtypeStruct((n, l), jnp.int32)
        _mf_fused_pipeline.lower(
            msa_spec, l, q, float(seqid), float(pseudocount), jnp.float32
        ).compile()
    # the CLI also computes weights standalone (metadata Meff header)
    _weights_warmup(n, l, q, seqid, mesh)
    dt = time.perf_counter() - t0
    logger.info(
        "mfDCA warmup (N=%d, L=%d, q=%d%s): %.1f s compile",
        n, l, q, "" if mesh is None else f", mesh {dict(mesh.shape)}", dt,
    )
    return dt


def _chunk_todos(max_iterations: int, chunk_size: Optional[int]):
    """Every distinct num_steps the chunked driver loop will request."""
    todos = set()
    rem = int(max_iterations)
    step = rem if chunk_size is None else int(chunk_size)
    while rem > 0:
        todo = min(step, rem)
        todos.add(todo)
        rem -= todo
    return sorted(todos)


def warmup_plm(
    n: int,
    l: int,
    q: int,
    *,
    seqid: float = 0.8,
    max_iterations: int = 100,
    chunk_size: Optional[int] = 50,
    m: int = 5,
    seq_block: Optional[int] = None,
    mm_bf16: Optional[bool] = None,
    param_space: str = "auto",
    mesh=None,
    hist_bf16: Optional[bool] = None,
) -> float:
    """Compile the plmDCA programs (weights, optimizer init, every chunk-size
    step program the fit will invoke) for an (N, L, q) problem; returns
    seconds spent.  Mirrors :func:`pydca_tpu.plm.fit_plm`'s dispatch: the
    fused direction loop for full-batch compact runs, the generic loop for
    streaming (``seq_block``) / ``param_space='w2'``, including the
    auto-streaming threshold, the mesh-divisible ``seq_block`` rounding and
    the bf16-history default."""
    import jax
    import jax.numpy as jnp

    from . import stats  # noqa: F401  (dispatch constants)
    from .meanfield import _resolve_mesh
    from .plm import (
        _plm_fused_state0,
        _plm_fused_steps,
        _plm_lbfgs_state0,
        _plm_lbfgs_steps,
        _prep_msa_jit,
        _resolve_param_space,
        auto_seq_block,
        default_hist_bf16,
        default_mm_bf16,
    )

    if mm_bf16 is None:
        mm_bf16 = default_mm_bf16()
    if hist_bf16 is None:
        hist_bf16 = default_hist_bf16()
    mesh = _resolve_mesh(mesh)
    w2space = _resolve_param_space(param_space, l, q, m, mm_bf16)
    t0 = time.perf_counter()
    _weights_warmup(n, l, q, seqid, mesh)

    # scoring programs: the FN + APC pipeline the CLI always runs
    from . import score as score_mod

    p_pairs = l * (l - 1) // 2
    score_mod.frobenius_norms.lower(
        jax.ShapeDtypeStruct((p_pairs, q - 1, q - 1), jnp.float32)
    ).compile()
    score_mod.apc.lower(
        jax.ShapeDtypeStruct((p_pairs,), jnp.float32), l
    ).compile()

    if seq_block is None:
        seq_block = auto_seq_block(n, l, q)
    chunked = seq_block is not None
    lam = jnp.float32(0.2 * (l - 1))
    todos = _chunk_todos(max_iterations, chunk_size)

    import contextlib

    mesh_ctx = jax.set_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with mesh_ctx:
        if chunked:
            block = int(seq_block)
            if mesh is not None:
                # fit_plm rounds the block up so each scan step's rows
                # shard evenly over 'data'
                ndata = int(mesh.shape["data"])
                block = -(-block // ndata) * ndata
            nb = -(-n // block)
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                msa_spec = jax.ShapeDtypeStruct(
                    (nb, block, l), jnp.int32,
                    sharding=NamedSharding(mesh, P(None, "data", None)),
                )
                w_spec = jax.ShapeDtypeStruct(
                    (nb, block), jnp.float32,
                    sharding=NamedSharding(mesh, P(None, "data")),
                )
            else:
                msa_spec = jax.ShapeDtypeStruct((nb, block, l), jnp.int32)
                w_spec = jax.ShapeDtypeStruct((nb, block), jnp.float32)
        elif mesh is not None:
            _, msa_spec, w_spec, _ = _mesh_specs(mesh, n, l)
        else:
            msa_spec = jax.ShapeDtypeStruct((n, l), jnp.int32)
            w_spec = jax.ShapeDtypeStruct((n,), jnp.float32)
        pidx_spec = jax.ShapeDtypeStruct((l, l), jnp.int32)

        from jax.sharding import NamedSharding

        def _specs_of(compiled):
            # out_info carries shape+dtype+sharding; strip the concrete
            # Layout, and keep the sharding only when it is a mesh
            # NamedSharding — a SingleDeviceSharding would stamp
            # sdy.sharding annotations into the lowered module that a
            # real jit call on plain arrays does not have (cache miss)
            def spec(i):
                if isinstance(i.sharding, NamedSharding):
                    return jax.ShapeDtypeStruct(
                        i.shape, i.dtype, sharding=i.sharding
                    )
                return jax.ShapeDtypeStruct(i.shape, i.dtype)

            return jax.tree_util.tree_map(spec, compiled.out_info)

        if not chunked and not w2space:
            # fused direction loop: chain each program's output shardings
            # into the next lower so the cache keys match the real run
            prep_c = _prep_msa_jit.lower(msa_spec, l, q).compile()
            state_c = _plm_fused_state0.lower(
                msa_spec, w_spec, lam, lam, l, q, m, mm_bf16, hist_bf16
            ).compile()
            x1h_spec, maskq_spec = _specs_of(prep_c)
            state_spec = _specs_of(state_c)
            for todo in todos:
                _plm_fused_steps.lower(
                    state_spec, x1h_spec, maskq_spec, w_spec, lam, lam,
                    l, q, todo, mm_bf16,
                ).compile()
        else:
            # generic loop (streaming / w2): chain the compiled state's
            # out_info too — an eval_shape spec would drop the GSPMD
            # shardings and the real sharded run would miss the cache
            # (review r5)
            state_c = _plm_lbfgs_state0.lower(
                msa_spec, w_spec, pidx_spec, lam, lam, l, q, m, chunked,
                mm_bf16, w2space,
            ).compile()
            state_spec = _specs_of(state_c)
            for todo in todos:
                _plm_lbfgs_steps.lower(
                    state_spec, msa_spec, w_spec, pidx_spec, lam, lam, l, q,
                    todo, chunked, mm_bf16, w2space,
                ).compile()
    dt = time.perf_counter() - t0
    logger.info(
        "plmDCA warmup (N=%d, L=%d, q=%d, %d iters%s%s): %.1f s compile",
        n, l, q, max_iterations,
        f", seq_block={seq_block}" if chunked else "",
        "" if mesh is None else f", mesh {dict(mesh.shape)}",
        dt,
    )
    return dt
