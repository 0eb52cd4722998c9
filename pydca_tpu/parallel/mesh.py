"""Device mesh + sharding policies for multi-chip DCA.

The reference's only parallelism is single-node OpenMP threads
(``pydca/plmdca/plmdca_numerics.cpp:490``, SURVEY.md section 2b).  The
mapping of the classic parallelism taxonomy for this workload (every card
reaches every other at the same rate, so the mesh follows the algorithm):

- **data parallel (``data`` axis)** — shard the N sequences of the MSA.
  Every contraction over N (sequence weights row-blocks, fi, the gram
  matrix, the pseudolikelihood loss and its gradient) is a plain sum, so
  GSPMD inserts ``psum`` over the interconnect automatically when inputs are placed with
  ``P('data', ...)``.  This is the axis that scales to 100k+-sequence MSAs.
- **model/tensor parallel (``model`` axis)** — shard the site/pair tensors:
  the (L*q, L*q) gram and (L(q-1))^2 correlation matrices row-block wise,
  the per-pair scoring (FN/DI) over the P = L(L-1)/2 pair axis, and the
  (N, L*q) logits over their second dimension.
- sequence/pipeline/expert parallelism in the LLM sense have **no
  analogue**: there is no attention over tokens and no layer stack; the
  long axes here are alignment depth N and the pair axis L^2/2
  (SURVEY.md section 5).

Batch/family parallelism (many MSAs at once) vmaps over a leading family
axis and shards it like ``data``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_msa",
    "P",
]


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ('data', 'model') mesh over the available devices.

    Defaults to all devices on the data axis (the natural DCA scaling axis).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"have {len(devices)}"
        )
    grid = np.array(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, axis_names=("data", "model"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (sequence) axis over 'data', replicate the rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def model_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading axis over 'model' (site/pair tensors)."""
    return NamedSharding(mesh, P("model", *([None] * (ndim - 1))))


def shard_msa(mesh: Mesh, msa, weights=None, pad_to_multiple: bool = True):
    """Place an (N, L) MSA (and optional (N,) weights) data-parallel.

    Pads N up to a multiple of the data-axis size with zero-weight rows,
    which leaves every *weighted* statistic (fi, fij, gram, plm loss)
    unchanged.  Compute sequence weights BEFORE padding: the all-pairs
    identity count sees every row, including pads.  Returns
    (msa_sharded, weights_sharded).
    """
    import jax.numpy as jnp

    n_data = mesh.shape["data"]
    n, l = msa.shape
    npad = (-n) % n_data
    msa = jnp.asarray(msa)
    if weights is None:
        weights = jnp.ones((n,), jnp.float32)
    weights = jnp.asarray(weights)  # keep caller's dtype (f64 mf parity path)
    if not jnp.issubdtype(weights.dtype, jnp.floating):
        weights = weights.astype(jnp.float32)
    if npad and pad_to_multiple:
        msa = jnp.pad(msa, ((0, npad), (0, 0)), constant_values=0)
        weights = jnp.pad(weights, (0, npad))
    msa = jax.device_put(msa, data_sharding(mesh, 2))
    weights = jax.device_put(weights, data_sharding(mesh, 1))
    return msa, weights
