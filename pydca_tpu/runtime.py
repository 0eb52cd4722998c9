"""The one place that knows which backend the program runs on.

:func:`backend` answers ``"gpu"`` or ``"cpu"``; every backend-dependent
default (the identity-count kernel dispatch, the L-BFGS history dtype, the
memory budgets, the persistent compilation cache) asks it and nothing
else.

The CLI model is one command per process (as in the reference), which makes
XLA compile time a first-run tax on every invocation.  The persistent
compilation cache amortizes that across processes: later identical-shape
runs load the compiled executable instead of compiling it.
"""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = [
    "backend",
    "require_gpu",
    "card",
    "memory_budget",
    "cache_dir",
    "enable_compilation_cache",
]

# Fixed cache location: the path is part of every cache key, so it must
# not move between processes (no temp, pid or time-based paths).
_CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def backend() -> str:
    """``"gpu"`` or ``"cpu"``: the platform of JAX's default device."""
    platform = jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: pydca_tpu runs on an "
            "NVIDIA GPU or on the CPU"
        )
    return platform


def require_gpu() -> jax.Device:
    """Restrict JAX to CUDA and return its first device.

    Without the restriction JAX falls back to the CPU when the CUDA plugin
    fails to load, and a measurement script would time the CPU under the
    card's name.  Call it before anything starts a JAX backend.
    """
    jax.config.update("jax_platforms", "cuda")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform}")
    return dev


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def memory_budget(fraction: float, cpu_bytes: int) -> int:
    """``fraction`` of the memory one device may allocate
    (``bytes_limit``), or ``cpu_bytes`` on the CPU.

    Raises on a GPU that reports no limit: a budget derived from a guess
    would fail later, far from its cause.
    """
    if backend() == "cpu":
        return cpu_bytes
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{jax.devices()[0].device_kind} reports no bytes_limit; "
            "cannot size the device memory budgets"
        )
    return int(fraction * stats["bytes_limit"])


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` at the
    checkout root."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache on the GPU; returns its
    directory, or ``None`` where the cache stays off.

    CPU stays off: XLA:CPU persists AOT executables keyed on the compiling
    host's machine features and warns of possible SIGILL when they differ
    from the executing host, so CPU runs are better off recompiling.

    Call it before the first compilation of the process: JAX decides once,
    at its first compile, whether a cache exists.
    """
    if backend() != "gpu":
        return None
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        # JAX reads the environment variable itself; set only the default
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program: a CLI process compiles a handful of sub-second
    # scoring/extraction jits whose compiles otherwise recur every run
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
