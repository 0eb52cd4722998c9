"""Packaging for pydca_tpu, Direct Coupling Analysis on JAX.

Console scripts mirror the reference's entry points (``setup.py:67-73`` of
KIT-MBS/pydca): ``mfdca``, ``plmdca``, ``pydca``.  The optional native FASTA
codec extension builds lazily at runtime (see pydca_tpu/native), so no
compiler is required at install time.
"""

from setuptools import find_packages, setup

setup(
    name="pydca_tpu",
    version="0.1.0",
    description="Direct Coupling Analysis (mfDCA + plmDCA) on JAX, for NVIDIA GPUs",
    packages=find_packages(include=["pydca_tpu", "pydca_tpu.*"]),
    python_requires=">=3.10",
    install_requires=["jax>=0.9,<0.10", "numpy"],
    entry_points={
        "console_scripts": [
            "mfdca=pydca_tpu.cli.mfdca_main:run_meanfield_dca",
            "plmdca=pydca_tpu.cli.plmdca_main:run_plm_dca",
            "pydca=pydca_tpu.cli.main:run_pydca",
            "a2m2aln=pydca_tpu.extras.a2m2aln:run_a2m2aln",
        ],
    },
)
