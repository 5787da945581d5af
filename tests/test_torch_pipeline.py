"""The port's own chain simulate_ccd → extract → reconstruct → average on
the CPU, from its settings alone, at the sizes and overrides of
tests/test_pipeline_integration.py, through run_worker(..., device="cpu")
in a temporary XFRAME_TPU_HOME.

Each stage meets that test's schema assertions (keys, shapes, dtypes,
finiteness, Friedel-zero odd orders, PSD B_l, error-ranked restarts,
PRTF/FQCB ≤ 1), each stage reads the previous one's archive, and the
result meets its ground-truth gate: the averaged density correlates with
the simulated two spheres above 0.85 and the best restart above 0.75
(tests/test_pipeline_integration.py:211,216).
"""
import os

import numpy as np
import pytest
import torch

from test_torch_reconstruct import (L_REC, L_SIM, N_REC, N_SIM, SHAPES,
                                    reconstruct_overrides)
from test_torch_average import AVERAGE_OVERRIDES, _grid_ft
from xframe_tpu_torch.main import run_worker
from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth
from xframe_tpu_torch.projects.fxs.store import archive_ext

SIMULATE = {
    "structure_name": "pytest", "dimensions": 3,
    "grid": {"n_radial_points": N_SIM, "max_order": L_SIM, "max_q": 0.5},
    "shapes": SHAPES,
    "cross_correlation": {"method": "back_substitution",
                          "xray_wavelength": 1.23984},
}
EXTRACT = {"structure_name": "pytest", "dimensions": 3, "max_order": L_SIM}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test processes would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xf_pipeline_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = path
    yield path
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


@pytest.fixture(scope="module")
def ccd(home):
    return run_worker("fxs", "simulate_ccd", overrides=SIMULATE,
                      device="cpu")


@pytest.fixture(scope="module")
def invariants(ccd):
    return run_worker("fxs", "extract", overrides=EXTRACT, device="cpu")


@pytest.fixture(scope="module")
def reconstructions(invariants):
    return run_worker("fxs", "reconstruct",
                      overrides=reconstruct_overrides(), device="cpu")


@pytest.fixture(scope="module")
def average(reconstructions):
    return run_worker("fxs", "average", overrides=AVERAGE_OVERRIDES,
                      device="cpu")


def _run_folder(home, kind, name):
    return os.path.join(home, "data", "fxs", kind, "pytest", "run_1", name)


def test_simulate_ccd_schema(ccd, home):
    assert ccd["dimensions"] == 3
    n_phi = len(ccd["angular_points"])
    cc = ccd["cross_correlation"]["I1I1"]
    assert cc.shape == (N_SIM, N_SIM, n_phi) and cc.dtype == np.float32
    assert ccd["average_intensity"].shape == (N_SIM,)
    assert np.isfinite(cc).all()
    np.testing.assert_array_equal(cc, np.swapaxes(cc, 0, 1))
    assert os.path.exists(_run_folder(home, "ccd", "ccd" + archive_ext()))


def test_extract_schema(invariants, home):
    bl = invariants["deg_2_invariant"]["I1I1"]
    assert bl.shape == (L_SIM + 1, N_SIM, N_SIM) and np.iscomplexobj(bl)
    proj = invariants["data_projection_matrices"]["I1I1"]
    assert len(proj) == L_SIM + 1
    for l, v in enumerate(proj):
        assert v.shape == (N_SIM, min(2 * l + 1, N_SIM)), l
    assert np.allclose(bl[1::2], 0)
    for l in range(0, L_SIM + 1, 2):
        lam = np.linalg.eigvalsh((bl[l] + bl[l].conj().T) / 2)
        assert lam.min() > -1e-6 * max(lam.max(), 1e-30)
    assert os.path.exists(_run_folder(home, "invariants",
                                      "proj_data" + archive_ext()))


def test_reconstruct_schema(reconstructions, home):
    cfg = reconstructions["configuration"]
    assert cfg["internal_grid"]["real_grid"].shape == (N_REC,)
    results = reconstructions["reconstruction_results"]
    assert len(results) == 3
    n_theta = len(cfg["internal_grid"]["thetas"])
    n_phi = len(cfg["internal_grid"]["phis"])
    for res in results.values():
        assert res["real_density"].shape == (N_REC, n_theta, n_phi)
        assert res["support_mask"].dtype == bool
        err = np.asarray(res["error_dict"]["main"])
        assert err.shape == (2 * 25 + 15,) and np.isfinite(err).all()
    finals = [results[str(i)]["error_dict"]["final"] for i in range(3)]
    assert finals[0] == min(finals)
    e0 = np.asarray(results["0"]["error_dict"]["main"])
    assert e0[-1] < e0[:5].mean()
    assert os.path.exists(_run_folder(home, "reconstructions",
                                      "data" + archive_ext()))


def test_average_schema(average, home):
    avg = average["average"]
    assert avg["real_density"].shape == avg["normalized_real_density"].shape
    assert len(average["aligned"]) >= 1 and len(average["input"]) == 3
    metrics = average["resolution_metrics"]
    for name in ("PRTF", "FQCB_from_density"):
        assert metrics[name].shape == (N_REC,)
        assert np.isfinite(metrics[name]).all()
        assert (metrics[name] <= 1.0 + 1e-6).all()
    assert average["rotation_metric"]["angles"].shape[1] == 3
    assert os.path.exists(_run_folder(home, "averages",
                                      "average_results" + archive_ext()))


def test_chain_meets_the_ground_truth(average, reconstructions):
    ft, integ = _grid_ft(reconstructions["configuration"])
    corr = align_to_ground_truth(average["average"]["real_density"], SHAPES,
                                 ft, integ.w_broadcast)[0]
    best = reconstructions["reconstruction_results"]["0"]["real_density"]
    corr_b = align_to_ground_truth(best, SHAPES, ft, integ.w_broadcast)[0]
    print(f"average {corr:.5f}, best restart {corr_b:.5f}")
    assert corr > 0.85
    assert corr_b > 0.75
