"""The port's average worker against the JAX package's (CPU).

The JAX chain simulate_ccd → extract → reconstruct runs at the sizes of
tests/test_pipeline_integration.py; its reconstructions go into the port's
`.npz` layout (convert.save_reconstructions), and both average workers
take the average overrides of that test (PRTF, FSC and FQCB on):

  * the alignment: inversion flags equal, angles equal wherever the
    correlation's maximum is clear (as tests/test_torch_alignment.py
    defines it), l2 distances within 1e-4;
  * the average density within 1e-4 of its maximum;
  * PRTF, FSC and FQCB within 1e-4 absolute;
  * the schema assertions of test_average_schema;
  * the port's average of its own reconstructions correlates with the
    simulated truth above 0.85 (the JAX gate,
    tests/test_pipeline_integration.py:210-211).
"""
import os

import numpy as np
import pytest
import torch

import xframe_tpu as xf

from test_torch_reconstruct import (L_REC, N_REC, SHAPES, jax_invariants,
                                    reconstruct_overrides)
from xframe_tpu_torch.convert import save_reconstructions
from xframe_tpu_torch.main import run_worker, select_worker
from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
from xframe_tpu_torch.ops.integrate import SphericalIntegrator
from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth

AVERAGE_OVERRIDES = {
    "structure_name": "pytest",
    "selection": {"method": "least_error", "error_limit": 1.0,
                  "n_reconstructions": "all"},
    "l2_error_limit": 2.0,
    "resolution_metrics": {"PRTF": True, "FSC": True, "FQCB": True},
}
METRICS = ("PRTF", "PRTF_from_density", "PRTF_fxs", "PRTF_from_ft_density",
           "PRTF_ftI", "pseudo_FSC", "FSC", "FSC_half_bit",
           "FQCB_from_density", "FQCB_from_density_std",
           "FQCB_from_density_with_zero_order")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: on tensors this small, parallel test processes
    that each start a thread per core oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xf_torch_avg_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = path
    yield path
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


@pytest.fixture(scope="module")
def chain(home):
    """(invariants archive, JAX reconstructions, their port archive)."""
    _, inv_path = jax_invariants(home)
    xf.select_project("fxs", "reconstruct", overrides=reconstruct_overrides())
    rec = xf.run()
    rec_path = os.path.join(home, "port_reconstructions.npz")
    save_reconstructions(rec, rec_path)
    return inv_path, rec, rec_path


@pytest.fixture(scope="module")
def jax_average(chain):
    xf.select_project("fxs", "average", overrides=AVERAGE_OVERRIDES)
    return xf.run()


@pytest.fixture(scope="module")
def port_average(chain):
    """The port's average worker on the JAX reconstructions (the worker
    kept for its aligner)."""
    w = select_worker("fxs", "average",
                      overrides=dict(AVERAGE_OVERRIDES,
                                     reconstruction_files=[chain[2]]),
                      device="cpu")
    return w, w.run()


def _grid_ft(cfg):
    g = cfg["internal_grid"]
    ft = SphericalFourierTransform(
        N_REC, L_REC, q_max=float(cfg["q_max"]), mode="midpoint",
        reciprocity_coefficient=float(cfg["reciprocity_coefficient"]),
        n_theta=len(g["thetas"]), n_phi=len(g["phis"]), device="cpu")
    integ = SphericalIntegrator(ft.rs, len(g["thetas"]), len(g["phis"]),
                                device="cpu")
    return ft, integ


def _clear(aligner, ref_coeff, rho, inverted):
    """The correlation's top two values are ≥ 1e-3 of its maximum apart."""
    c = aligner.coefficients(rho)
    if inverted:
        c = aligner.invert_parity(c)
    C = aligner.corr.correlate(aligner._truncate(ref_coeff),
                               aligner._truncate(c),
                               radial_weights=aligner._w_r).numpy().ravel()
    top = np.sort(C)[-2:]
    return top[1] - top[0] >= 1e-3 * abs(top[1])


def test_alignment_matches_jax(port_average, jax_average):
    w, got = port_average
    want = jax_average
    g, j = got["rotation_metric"], want["rotation_metric"]
    assert np.array_equal(g["inverted"], j["inverted"])
    np.testing.assert_allclose(g["l2_to_ref"], j["l2_to_ref"], atol=1e-4)
    assert len(got["aligned"]) == len(want["aligned"]) >= 2
    # the candidates as the aligner saw them: centered, normalized
    al = w.aligner
    rhos = torch.as_tensor(np.stack([got["input"][str(i)] for i in
                                     range(len(got["input"]))]).astype(
        np.complex64))
    rhos = al.center_batch(rhos)[0]
    rhos = rhos / rhos.abs().amax(dim=(-3, -2, -1))[:, None, None, None]
    ref_coeff = al.coefficients(rhos[0])
    for i in range(1, len(rhos)):
        if _clear(al, ref_coeff, rhos[i], bool(g["inverted"][i])):
            np.testing.assert_allclose(g["angles"][i], j["angles"][i],
                                       atol=1e-12)


def test_average_density_matches_jax(port_average, jax_average):
    got, want = port_average[1]["average"], jax_average["average"]
    for key in ("real_density", "normalized_real_density",
                "reciprocal_density"):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), key
    a = port_average[1]["centered_average"]
    b = np.asarray(jax_average["centered_average"])
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    np.testing.assert_allclose(port_average[1]["scaling_factors"],
                               jax_average["scaling_factors"], rtol=1e-5)


@pytest.mark.parametrize("name", METRICS)
def test_resolution_metric_matches_jax(port_average, jax_average, name):
    a = np.asarray(port_average[1]["resolution_metrics"][name])
    b = np.asarray(jax_average["resolution_metrics"][name])
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-4


def test_average_schema(port_average):
    """The assertions of test_average_schema on the port's result."""
    res = port_average[1]
    avg = res["average"]
    assert avg["real_density"].shape == avg["normalized_real_density"].shape
    assert "reciprocal_density" in avg
    assert len(res["aligned"]) >= 1
    assert len(res["input"]) == 3
    metrics = res["resolution_metrics"]
    assert metrics["PRTF"].shape == (N_REC,)
    assert np.isfinite(metrics["PRTF"]).all()
    assert (metrics["PRTF"] <= 1.0 + 1e-6).all()
    assert res["rotation_metric"]["angles"].shape[1] == 3
    fq = metrics["FQCB_from_density"]
    assert fq.shape == (N_REC,)
    assert np.isfinite(fq).all() and (fq <= 1.0 + 1e-6).all()
    assert "FQCB_from_density_std" in metrics
    assert set(res["timing"]) >= {"load_s", "align_s", "metrics_s",
                                  "average_s", "save_s"}
    from xframe_tpu_torch.projects.fxs.store import archive_ext
    path, run = port_average[0].saved
    assert path.endswith(os.path.join("averages", "pytest", f"run_{run}",
                                      "average_results" + archive_ext()))
    assert os.path.exists(path)


def test_own_average_matches_truth(chain):
    """The port's chain end to end: its reconstruct worker, then its
    average worker on that run, against the simulated truth."""
    rec = run_worker("fxs", "reconstruct",
                     overrides=reconstruct_overrides(chain[0],
                                                     structure_name="own"),
                     device="cpu")
    avg = run_worker("fxs", "average",
                     overrides=dict(AVERAGE_OVERRIDES, structure_name="own"),
                     device="cpu")
    ft, integ = _grid_ft(rec["configuration"])
    corr = align_to_ground_truth(avg["average"]["real_density"], SHAPES, ft,
                                 integ.w_broadcast)[0]
    assert corr > 0.85


@pytest.mark.parametrize("routine", ["run", "average", "load_invariants"])
def test_unported_load_routine_raises(routine):
    """Only the reconstructions loader is ported; any other load_routine is
    refused before anything is read."""
    worker = select_worker("fxs", "average",
                           overrides={"load_routine": routine}, device="cpu")
    with pytest.raises(NotImplementedError, match="load_routine"):
        worker.run()
