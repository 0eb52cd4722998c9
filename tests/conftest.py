"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64 support.

Must set flags before jax initializes a backend, hence the env mutation at
import time.  Multi-chip sharding tests use the 8 virtual CPU devices; tests
of code that runs only on the GPU carry the ``gpu`` marker and skip here.

Parity tests read the upstream pydca alignments from a checkout of the
reference project named by ``PYDCA_REFERENCE_DIR``; without it they skip.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Tests run on the CPU even where a GPU is visible, except for a run of the
# ``gpu``-marked tests on the card:
#     PYDCA_TESTS_ON_GPU=1 python -m pytest -m gpu tests/
if os.environ.get("PYDCA_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Files of the reference checkout, relative to PYDCA_REFERENCE_DIR.
REFERENCE_FILES = {
    "rf00167": ("examples", "MSA_RF00167.fa"),
    "rf00167_ref": ("examples", "ref_RF00167.fa"),
    "pf02826": ("tests", "tests_input", "PF02826.faa"),
    "pf02826_ref": ("tests", "tests_input", "ref_seq_PF02826.faa"),
    "rf00059": ("tests", "tests_input", "MSA_RF00059_trimmed_gap_treshold_50.fa"),
    "rf00059_ref": ("tests", "tests_input", "ref_seq_RF00059.faa"),
    **{
        f"rf00059_test{k}": ("tests", "tests_input", f"ref_seq_RF00059_test{k}.faa")
        for k in (1, 2, 3, 4)
    },
}


def reference_file(name: str) -> str:
    """Path of a reference-checkout file, or skip the calling test.

    Call it inside a test or fixture, never at import time: whether the
    file exists must not change which tests a pytest-xdist worker collects.
    """
    root = os.environ.get("PYDCA_REFERENCE_DIR")
    if not root:
        pytest.skip("PYDCA_REFERENCE_DIR (a reference pydca checkout) is not set")
    path = os.path.join(root, *REFERENCE_FILES[name])
    if not os.path.exists(path):
        pytest.skip(f"reference file {path} is missing")
    return path


@pytest.fixture(scope="session")
def reference():
    """:func:`reference_file` as a fixture."""
    return reference_file


@pytest.fixture
def gpu():
    """The GPU for a ``gpu``-marked test, or skip: compiled kernels have no
    CPU form."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs a GPU: PYDCA_TESTS_ON_GPU=1 python -m pytest -m gpu tests/"
        )
    return jax.devices()[0]


@pytest.fixture(scope="session")
def rf00167_path():
    return reference_file("rf00167")


@pytest.fixture(scope="session")
def pf02826_path():
    return reference_file("pf02826")


@pytest.fixture(scope="session")
def rf00059_path():
    return reference_file("rf00059")
