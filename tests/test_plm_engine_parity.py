"""plm engine scoring-pipeline parity: same params, reference vs ours.

``tests/goldens/ref_plm_engine.npz`` holds the reference PYTHON engine's
FN / FN_APC / DI / DI_APC outputs computed on the committed backend
parameter goldens (``scripts/gen_plm_engine_goldens.py`` patches only the
backend fetch, every scoring line is reference code).  Feeding our engine
the identical parameter vector isolates the scoring pipeline: gap-state
exclusion (``plmdca.py:246-268``), gauge shift + FN (:437-482), APC
(:484-524), and the DI path with pseudocount hard-coded to 0.5 (:638-720).
"""

import os

import numpy as np
import pytest

from conftest import reference_file

from pydca_tpu.plm import PlmDCA

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")

DATASETS = {
    "rf00167": ("rf00167", "rna"),
    "pf02826": ("pf02826", "protein"),
}


def _dense(pairs, scores, l):
    out = np.full(l * (l - 1) // 2, np.nan)
    i = pairs[:, 0].astype(np.int64)
    j = pairs[:, 1].astype(np.int64)
    out[l * (l - 1) // 2 - (l - i) * (l - i - 1) // 2 + j - i - 1] = scores
    assert not np.isnan(out).any()
    return out


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum() / np.sqrt((ra**2).sum() * (rb**2).sum()))


def _engine_with_golden_params(name):
    name_file, biomolecule = DATASETS[name]
    msa_file = reference_file(name_file)
    params = np.load(os.path.join(GOLDENS, f"ref_plm_{name}_it100.npz"))["params"]
    inst = PlmDCA(msa_file, biomolecule)
    inst.get_fields_and_couplings_from_backend = lambda: params
    return inst


def _check(name, inst, golden, kind, method, rtol, atol, rho=0.9999):
    l = inst.msa.seqs_len
    ref = _dense(
        golden[f"{name}_{kind}_pairs"], golden[f"{name}_{kind}_scores"], l
    )
    scores = method()
    ours = _dense(
        np.array([p for p, _ in scores], np.int32),
        np.array([s for _, s in scores]),
        l,
    )
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)
    assert _spearman(ours, ref) >= rho


@pytest.fixture(scope="module")
def rf_case():
    golden = np.load(os.path.join(GOLDENS, "ref_plm_engine.npz"))
    return _engine_with_golden_params("rf00167"), golden


class TestPlmEngineParityRF00167:
    def test_fn(self, rf_case):
        inst, golden = rf_case
        _check("rf00167", inst, golden, "fn", inst.compute_sorted_FN, 1e-5, 1e-6)

    def test_fn_apc(self, rf_case):
        inst, golden = rf_case
        _check(
            "rf00167", inst, golden, "fn_apc", inst.compute_sorted_FN_APC,
            1e-4, 1e-5,
        )

    def test_di(self, rf_case):
        inst, golden = rf_case
        # per-pair fixed point to tol 1e-4 on both sides
        _check("rf00167", inst, golden, "di", inst.compute_sorted_DI, 5e-3, 5e-5)

    def test_di_apc(self, rf_case):
        inst, golden = rf_case
        _check(
            "rf00167", inst, golden, "di_apc", inst.compute_sorted_DI_APC,
            5e-3, 5e-5, rho=0.999,
        )


@pytest.mark.slow
class TestPlmEngineParityPF02826:
    @pytest.fixture(scope="class")
    def case(self):
        golden = np.load(os.path.join(GOLDENS, "ref_plm_engine.npz"))
        return _engine_with_golden_params("pf02826"), golden

    def test_fn_apc(self, case):
        inst, golden = case
        _check(
            "pf02826", inst, golden, "fn_apc", inst.compute_sorted_FN_APC,
            1e-4, 1e-5,
        )

    def test_di_apc(self, case):
        inst, golden = case
        _check(
            "pf02826", inst, golden, "di_apc", inst.compute_sorted_DI_APC,
            5e-3, 1e-4, rho=0.999,
        )
