"""The port's extract worker and invariant engine against the JAX package's
(CPU, float64).

The JAX simulate_ccd runs at the sizes of tests/test_pipeline_integration.py
(N = 48, L = 14) and its CC goes into the port's archive through
`convert.save_ccd`. On that CC, with the average intensity subtracted as
extract does, the port is held to the JAX package within 1e-8 of the
reference's max (float64 sums in another order; the back substitution
divides by P̄_l^l products, so the high orders carry the most):

  * every B_l extraction mode, over all orders;
  * the CC masks (equal), the CC modifications, PSD on the q-limits, the
    q-limit lines (equal), V_l V_l† and the eigenvalues (V_l itself only up
    to a phase per column), the error estimates;
  * the unknown unitary W as V2·W·V1† (both methods) on well-posed data;
  * the extract worker end to end, and the multi-dataset case of
    tests/test_pipeline_integration.py (I2I2, the B_l of every dataset, the
    FQC curve; I2I1's W, which that data leaves ill-posed, held by both
    packages to the JAX test's 5e-2 reconstruction of B_21);
  * `extraction_mode: shapes` within 1e-4 of max: its B_l come from the
    float32 SHT chain, as the simulate_ccd worker's do.

The SHT-constraint options run their float32 SHT round trips through the
plain transforms on the CPU (FusedSHT's CPU path) against the JAX
package's: prephasing and the low-resolution optimization are held by
V_l V_l† (V_l itself rotates by a Procrustes whose blocks are rank
deficient, so float32 rounding moves it), by the convergence flag and the
iteration count at which it stopped (the JAX package's host reads
counted), and by the negative share of the intensity the prephased V_l
synthesize (within 1e-2 relative). The particle-number estimate's
negative shares agree within NEG_POINTS grid points per scale and
n_particles within one scale step, for both methods. The 2D path (A.16)
raises.
"""
import os

import numpy as np
import pytest
import torch

from xframe_tpu.projects.fxs import invariants as jinv

from xframe_tpu_torch.convert import save_ccd
from xframe_tpu_torch.main import run_worker
from xframe_tpu_torch.projects.fxs import invariants as tinv
from xframe_tpu_torch.projects.fxs.store import load_invariants

L_SIM, N_SIM = 14, 48
LAM = 1.23984
TOL = 1e-8
SIMULATE = {
    "structure_name": "pytest", "dimensions": 3,
    "grid": {"n_radial_points": N_SIM, "max_order": L_SIM, "max_q": 0.5},
    "shapes": {"types": ["sphere", "sphere"],
               "centers": [[0, 0, 0], [30, 1.2, 0.7]],
               "sizes": [20, 14], "densities": [1.0, 0.7],
               "random_orientation": [False, False]},
    "cross_correlation": {"method": "back_substitution",
                          "xray_wavelength": LAM},
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
    path = str(tmp_path_factory.mktemp("xf_extract_home"))
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = path
    yield path
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


@pytest.fixture(scope="module")
def ccd(home):
    """The JAX simulate_ccd result, also written as the port's archive."""
    import xframe_tpu as xf
    xf.select_project("fxs", "simulate_ccd", overrides=SIMULATE)
    out = xf.run()
    path = os.path.join(home, "port_ccd.npz")
    save_ccd(out, path)
    return out, path


@pytest.fixture(scope="module")
def cc(ccd):
    """(qs, phis, CC with a(q1)a(q2) subtracted) as float64 host arrays."""
    c = ccd[0]
    avg = np.asarray(c["average_intensity"], dtype=float)
    cc = np.asarray(c["cross_correlation"]["I1I1"], dtype=float) \
        - avg[:, None, None] * avg[None, :, None]
    return (np.asarray(c["radial_points"], dtype=float),
            np.asarray(c["angular_points"], dtype=float), cc)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * max(np.abs(want).max(initial=0.0), 1e-300), err
    return err


def _gram(v):
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return v @ v.conj().T


MODES = ["back_substitution", "back_substitution_qqsym",
         "back_substitution_psd", "lstsq", "legendre"]


@pytest.mark.parametrize("zero_odd", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_bl_modes_match_jax(cc, mode, zero_odd):
    qs, _, c = cc
    want = jinv.cc_to_deg2_invariant_3d(c, LAM, qs, L_SIM,
                                        assume_zero_odd_orders=zero_odd,
                                        mode=mode)
    got = tinv.cc_to_deg2_invariant_3d(_t(c), LAM, qs, L_SIM,
                                       assume_zero_odd_orders=zero_odd,
                                       mode=mode)
    assert got.dtype == torch.complex128
    err = _close(got, want)
    per_order = np.abs(got.numpy() - want).max(axis=(1, 2))
    print(f"{mode} zero_odd={zero_odd}: max {err:.3e} of "
          f"{np.abs(want).max():.3e}, worst order {int(per_order.argmax())}")


def test_deg2_invariant_to_cc_matches_jax(cc):
    qs, _, c = cc
    bl = jinv.cc_to_deg2_invariant_3d(c, LAM, qs, L_SIM)
    for n_phi in (None, 32):
        _close(tinv.deg2_invariant_to_cc_3d(_t(bl), LAM, qs, n_phi=n_phi),
               jinv.deg2_invariant_to_cc_3d(bl, LAM, qs, n_phi=n_phi))


def test_pp_tables_match_jax(cc):
    qs = cc[0]
    th = np.arccos(qs * LAM / (4 * np.pi))
    tj = jinv.ewald_legendre_tables(th, 6)
    tt = tinv.ewald_legendre_tables(th, 6)
    _close(tt, tj, 1e-14)
    _close(tinv.pp_matrices(tt), jinv.pp_matrices(tj), 1e-14)
    for l in (0, 3, 6):
        _close(tinv.pp_matrix_single_l(tt, l),
               jinv.pp_matrix_single_l(tj, l), 1e-14)


MASKS = [
    dict(mask_type="none"),
    dict(mask_type="pixel_arc", pixel_size=60.0),
    dict(mask_type="pixel_arc", pixel_size=60.0, mask_at_pi=False),
    dict(mask_type="pixel_flat", pixel_size=80.0),
    dict(mask_type="pixel_custom", n_masked_pixels_phi=0.1,
         n_masked_pixels_q=0.2),
    dict(mask_type="pixel_custom", n_masked_pixels_phi=0.05,
         n_masked_pixels_q=1.0, mask_at_pi=False),
    dict(mask_type="donatelli", threshold=0.002),
]


@pytest.mark.parametrize("kw", MASKS)
def test_cc_masks_match_jax(cc, kw):
    qs, phis, _ = cc
    want = jinv.cc_mask(qs, phis, xray_wavelength=LAM, **kw)
    got = tinv.cc_mask(qs, phis, xray_wavelength=LAM, **kw)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_direct_mask(cc):
    qs, phis, c = cc
    custom = np.random.default_rng(1).uniform(size=c.shape) > 0.2
    np.testing.assert_array_equal(
        tinv.cc_mask(qs, phis, "direct", custom=custom).numpy(),
        jinv.cc_mask(qs, phis, "direct", custom=custom))


@pytest.fixture(scope="module")
def masked(cc):
    qs, phis, c = cc
    return jinv.cc_mask(qs, phis, "pixel_custom", n_masked_pixels_phi=0.1,
                        n_masked_pixels_q=0.3)


def _harmonics(c):
    """The first four circular harmonics of a CC, (4, n_q, n_q) complex:
    Hermitian-indefinite matrices."""
    if isinstance(c, torch.Tensor):
        return torch.fft.rfft(c, dim=-1)[..., :4].movedim(-1, 0)
    return np.moveaxis(np.fft.rfft(c, axis=-1)[..., :4], -1, 0)


MODIFICATIONS = {
    "pi_periodicity": (lambda m, c, k: m.enforce_pi_periodicity(c), False),
    "pi_periodicity_masked": (
        lambda m, c, k: m.enforce_pi_periodicity(c, k), True),
    "q1q2_symmetrize": (lambda m, c, k: m.symmetrize_cc_q1q2(c, k), True),
    "zero_harmonics": (lambda m, c, k: m.zero_cc_harmonics(
        c, max_order=9, zero_odd=True), False),
    "low_pass_in_q": (lambda m, c, k: m.low_pass_cc_in_q(c, 0.2), False),
    "binned_mean": (lambda m, c, k: m.binned_mean_cc(
        c, k, 7, 2 * np.pi * np.arange(c.shape[-1]) / c.shape[-1]), True),
    "interpolate_masked": (lambda m, c, k: m.interpolate_masked_cc(c, k),
                           True),
    "nearest_psd": (lambda m, c, k: m.nearest_positive_semidefinite_matrix(
        _harmonics(c)), False),
    "nearest_psd_low_positive": (
        lambda m, c, k: m.nearest_positive_semidefinite_matrix(
            _harmonics(c), low_positive_eigenvalues_to_zero=True), False),
}


@pytest.mark.parametrize("name", sorted(MODIFICATIONS))
def test_cc_modifications_match_jax(cc, masked, name):
    fn, uses_mask = MODIFICATIONS[name]
    c = cc[2]
    mask = masked if uses_mask else None
    want = fn(jinv, c, mask)
    got = fn(tinv, _t(c), None if mask is None else _t(mask))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == bool:
            np.testing.assert_array_equal(np.asarray(g), w)
        else:
            _close(g, w)


def test_interpolate_masked_matches_the_native_rows(cc, masked):
    """The JAX package's default path (the C++ rows) against the port."""
    c = cc[2]
    want = jinv.interpolate_masked_cc(c, masked, use_native=True)
    _close(tinv.interpolate_masked_cc(_t(c), _t(masked)), want)


LINES = [
    dict(min_line=((4, 0.004), (14, 0.34))),
    dict(max_line=((0, 0.5), (14, 0.2))),
    dict(min_line=((2, 0.05), (14, 0.3)), max_line=((0, 0.45), (14, 0.4))),
    dict(min_line=((2, 0.05), (14, 0.3)),
         q_mask=np.arange(N_SIM) > 3),
]


@pytest.mark.parametrize("kw", LINES)
def test_line_q_id_limits_and_psd(cc, kw):
    qs, _, c = cc
    mj, lj = jinv.line_q_id_limits(qs, L_SIM, **kw)
    mt, lt = tinv.line_q_id_limits(qs, L_SIM, **kw)
    np.testing.assert_array_equal(mt.numpy(), mj)
    np.testing.assert_array_equal(lt, lj)
    bl = jinv.cc_to_deg2_invariant_3d(c, LAM, qs, L_SIM)
    _close(tinv.apply_psd_on_q_limits(_t(bl), lt),
           jinv.apply_psd_on_q_limits(bl, lj))


@pytest.mark.parametrize("sort_mode", [0, 1])
@pytest.mark.parametrize("rank_cap", [True, False])
@pytest.mark.parametrize("limits", [False, True])
def test_projection_matrices_match_jax(cc, sort_mode, rank_cap, limits):
    qs, _, c = cc
    bl = jinv.apply_psd_on_q_limits(
        jinv.cc_to_deg2_invariant_3d(c, LAM, qs, L_SIM),
        [[0, N_SIM]] * (L_SIM + 1))
    lims = jinv.line_q_id_limits(qs, L_SIM, min_line=((2, 0.05),
                                                      (14, 0.3)))[1] \
        if limits else None
    pj, ej = jinv.deg2_invariant_to_projection_matrices(
        bl, q_id_limits=lims, rank_cap=rank_cap, sort_mode=sort_mode)
    pt, et = tinv.deg2_invariant_to_projection_matrices(
        _t(bl), q_id_limits=lims, rank_cap=rank_cap, sort_mode=sort_mode)
    for l in range(L_SIM + 1):
        assert tuple(pt[l].shape) == pj[l].shape
        _close(_gram(pt[l]), _gram(pj[l]))
        _close(et[l], ej[l])
    _close(tinv.projection_matrix_error_estimate(_t(bl), pt),
           jinv.projection_matrix_error_estimate(bl, pj), 1e-6)


def test_procrustes_and_padding():
    rng = np.random.default_rng(7)
    v1 = rng.normal(size=(9, 5)) + 1j * rng.normal(size=(9, 5))
    v2 = rng.normal(size=(9, 5)) + 1j * rng.normal(size=(9, 5))
    _close(tinv.solve_procrustes_problem(_t(v1), _t(v2)),
           jinv.solve_procrustes_problem(v1, v2))
    proj = [rng.normal(size=(9, min(2 * l + 1, 9))) + 0j for l in range(6)]
    pj = jinv.pad_projection_matrices(proj, 5, 9)
    pt = tinv.pad_projection_matrices([_t(v) for v in proj], 5, 9)
    _close(pt, pj, 0)
    for a, b in zip(tinv.unpad_projection_matrices(pt),
                    jinv.unpad_projection_matrices(pj)):
        _close(a, b, 0)


@pytest.mark.parametrize("method", ["procrustes", "direct"])
def test_unknown_unitary_matches_jax(method):
    """Two datasets' B_l = V V† of random full-rank V (distinct
    eigenvalues, 2l+1 < n_q) and the mixed B_21 = V2·U·V1† of a random
    unitary U per order."""
    rng = np.random.default_rng(0)
    n_q, L = 20, 6
    qs = np.linspace(0.02, 0.5, n_q)

    def cx(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)
    v1 = [cx(n_q, 2 * l + 1) for l in range(L + 1)]
    v2 = [v + 1e-3 * cx(*v.shape) for v in v1]
    u = [np.linalg.qr(cx(2 * l + 1, 2 * l + 1))[0] for l in range(L + 1)]
    b1 = np.stack([v @ v.conj().T for v in v1])
    b2 = np.stack([v @ v.conj().T for v in v2])
    b21 = np.stack([a @ w @ b.conj().T for a, w, b in zip(v2, u, v1)])
    p1, e1 = jinv.deg2_invariant_to_projection_matrices(b1)
    p2, e2 = jinv.deg2_invariant_to_projection_matrices(b2)
    wj, errj = jinv.calc_unknown_unitary_transform(p1, e1, p2, e2, b21, qs,
                                                   method=method)
    q1, f1 = tinv.deg2_invariant_to_projection_matrices(_t(b1))
    q2, f2 = tinv.deg2_invariant_to_projection_matrices(_t(b2))
    wt, errt = tinv.calc_unknown_unitary_transform(q1, f1, q2, f2, _t(b21),
                                                   qs, method=method)
    for l in range(L + 1):
        # V2·W·V1† does not depend on the columns' phases
        _close(q2[l] @ wt[l] @ q1[l].conj().T,
               p2[l] @ wj[l] @ p1[l].conj().T)
    # relative errors of a near-exact factorization: held absolutely
    assert np.abs(errt.numpy() - errj).max() <= TOL


@pytest.fixture(scope="module")
def extracted(ccd, home):
    """Both extract workers on the pipeline test's extract settings and the
    same CC. → (JAX invariants, port invariants, port archive)."""
    import xframe_tpu as xf
    xf.select_project("fxs", "extract", overrides=EXTRACT)
    want = xf.run()
    got = run_worker("fxs", "extract", overrides=dict(
        EXTRACT, input={"ccd_path": ccd[1]}), device="cpu")
    from xframe_tpu_torch.projects.fxs.store import ProjectStore
    store = ProjectStore("pytest")
    return want, got, store.path("invariants")[0]


def test_extract_worker_matches_jax(extracted):
    want, got, _ = extracted
    assert set(got) - {"timing"} == set(want)
    _close(got["deg_2_invariant"]["I1I1"], want["deg_2_invariant"]["I1I1"])
    np.testing.assert_array_equal(got["deg_2_invariant_masks"]["I1I1"],
                                  want["deg_2_invariant_masks"]["I1I1"])
    pt = got["data_projection_matrices"]["I1I1"]
    pj = want["data_projection_matrices"]["I1I1"]
    assert len(pt) == len(pj) == L_SIM + 1
    for a, b in zip(pt, pj):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(_gram(a), _gram(b))
    _close(got["data_projection_matrix_error_estimates"]["I1I1"],
           want["data_projection_matrix_error_estimates"]["I1I1"], 1e-6)
    for key in ("data_projection_matrices_q_id_limits", "data_radial_points",
                "data_angular_points", "average_intensity",
                "data_low_resolution_intensity_coefficients"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))
    for key in ("dimensions", "max_order", "xray_wavelength",
                "number_of_particles"):
        assert got[key] == want[key], key
    bl = got["deg_2_invariant"]["I1I1"]
    assert np.allclose(bl[1::2], 0)
    for l in range(0, L_SIM + 1, 2):
        lam = np.linalg.eigvalsh((bl[l] + bl[l].conj().T) / 2)
        assert lam.min() > -1e-6 * max(lam.max(), 1e-30)


def test_invariants_archive_is_what_reconstruct_reads(extracted):
    _, got, path = extracted
    inv = load_invariants(path)
    for key in ("data_radial_points", "average_intensity",
                "data_projection_matrices_q_id_limits",
                "data_low_resolution_intensity_coefficients"):
        np.testing.assert_array_equal(inv[key], got[key])
    assert inv["max_order"] == L_SIM and inv["number_of_particles"] == 1.0
    for a, b in zip(inv["data_projection_matrices"]["I1I1"],
                    got["data_projection_matrices"]["I1I1"]):
        np.testing.assert_array_equal(a, b)
    assert "timing" not in inv


def test_multi_dataset_unitary_and_fqc(ccd, home):
    """The datasets I1I1, I2I2 (with 1e-6 noise) and I2I1 of the JAX
    pipeline test, its FQC; no particle-number estimate (A.18)."""
    import xframe_tpu as xf
    from xframe_tpu.io import hdf5 as hdf5_io
    c = ccd[0]
    cc = np.asarray(c["cross_correlation"]["I1I1"])
    noise = 1e-6 * np.abs(cc).max() * np.random.default_rng(0).normal(
        size=cc.shape)
    data = {"dimensions": 3, "radial_points": c["radial_points"],
            "angular_points": c["angular_points"],
            "xray_wavelength": c["xray_wavelength"],
            "average_intensity": c["average_intensity"],
            "cross_correlation": {"I1I1": cc, "I2I2": cc + noise,
                                  "I2I1": cc},
            "num_images_processed": 1, "num_images_good": 1}
    folder = os.path.join(home, "data", "fxs", "ccd", "pytest_multi",
                          "run_1")
    os.makedirs(folder, exist_ok=True)
    hdf5_io.save(os.path.join(folder, "ccd.h5"), data)
    path = os.path.join(home, "port_multi_ccd.npz")
    save_ccd(data, path)
    ov = {"structure_name": "pytest_multi", "dimensions": 3,
          "max_order": L_SIM,
          "cross_correlation": {"datasets_to_process": ["I1I1", "I2I2",
                                                        "I2I1"]},
          "resolution_metrics": {"FQC": {"apply": True,
                                         "datasets": ["I1I1", "I2I2"]}}}
    xf.select_project("fxs", "extract", overrides=ov)
    want = xf.run()
    got = run_worker("fxs", "extract", overrides=dict(
        ov, input={"ccd_path": path}), device="cpu")
    pt, pj = got["data_projection_matrices"], want["data_projection_matrices"]
    assert set(pt) == set(pj) == {"I1I1", "I2I2", "I2I1"}
    for name in ("I2I2", "I2I1"):
        _close(got["deg_2_invariant"][name], want["deg_2_invariant"][name])
    for l in range(L_SIM + 1):
        _close(_gram(pt["I2I2"][l]), _gram(pj["I2I2"][l]))
    assert np.abs(got["data_projection_matrix_error_estimates"]["I2I2"]
                  - want["data_projection_matrix_error_estimates"]["I2I2"]
                  ).max() <= 1e-8
    # V1's eigenvalues reach down to rounding, so W_l, a procrustes fit
    # through V1's pseudo-inverse, is not fixed by the data beyond what it
    # reconstructs: both packages are held to the JAX test's bound there
    # (test_unknown_unitary_matches_jax holds W on well-posed data)
    b21 = got["deg_2_invariant"]["I2I1"]
    for p in (pt, pj):
        for l in (0, 2, 4):
            rec = p["I2I2"][l] @ p["I2I1"][l] @ p["I1I1"][l].conj().T
            assert np.abs(rec - b21[l]).max() < 5e-2 * np.abs(b21[l]).max()
    assert got["fqc"]["datasets"] == want["fqc"]["datasets"]
    _close(got["fqc"]["curve"], want["fqc"]["curve"])
    _close(got["fqc"]["q1q2"], want["fqc"]["q1q2"])


def test_extract_from_shapes_matches_jax(home):
    import xframe_tpu as xf
    ov = {"structure_name": "shapes_gt", "dimensions": 3, "max_order": 8,
          "extraction_mode": "shapes",
          "shapes_source": {
              "grid": {"n_radial_points": 24, "max_q": 0.5},
              "shapes": {"types": ["sphere", "sphere"],
                         "centers": [[0, 0, 0], [30, 1.2, 0.5]],
                         "sizes": [30, 18], "densities": [1.0, 0.6],
                         "random_orientation": [False, False]}}}
    xf.select_project("fxs", "extract", overrides=ov)
    want = xf.run()
    got = run_worker("fxs", "extract", overrides=ov, device="cpu")
    bl, bj = got["deg_2_invariant"]["I1I1"], want["deg_2_invariant"]["I1I1"]
    assert bl.shape == bj.shape == (9, 24, 24)
    _close(bl, bj, 1e-4)
    assert np.abs(bl[1::2]).max() == 0
    for a, b in zip(got["data_projection_matrices"]["I1I1"],
                    want["data_projection_matrices"]["I1I1"]):
        assert a.shape == b.shape
        _close(_gram(a), _gram(b), 1e-4)
    _close(got["average_intensity"], want["average_intensity"], 1e-4)
    assert got["deg_2_invariant_masks"]["I1I1"].all()


def test_low_resolution_coefficients(ccd, home):
    """low_resolution_intensity_approximation.max_order > 0 stores the
    first orders' V_l, which the reconstruct worker's guess reads."""
    got = run_worker("fxs", "extract", overrides=dict(
        EXTRACT, input={"ccd_path": ccd[1]},
        low_resolution_intensity_approximation={"max_order": 4}),
        device="cpu")
    lr = got["data_low_resolution_intensity_coefficients"]
    assert sorted(lr, key=int) == [str(l) for l in range(5)]
    for l in range(5):
        np.testing.assert_array_equal(
            lr[str(l)], got["data_projection_matrices"]["I1I1"][l])


# the 2D path runs (tests/test_torch_pipeline2d.py); atoms of a pdb_file
# are smeared in 3D only, so a 2D shapes extraction from one is refused
@pytest.mark.parametrize("overrides,match", [
    ({"dimensions": 2, "extraction_mode": "shapes", "shapes_source": {
        "grid": {"n_radial_points": 16, "max_q": 0.5, "n_phi": 32},
        "shapes": {"types": ["pdb"], "pdb_file": "model.pdb"}}},
     "2D polar grid"),
])
def test_unported_options_raise(home, overrides, match):
    with pytest.raises(NotImplementedError, match=match):
        run_worker("fxs", "extract", overrides=dict(EXTRACT, **overrides),
                   device="cpu")


def test_missing_dataset_raises(ccd, home):
    with pytest.raises(ValueError, match="datasets_to_process"):
        run_worker("fxs", "extract", overrides=dict(
            EXTRACT, input={"ccd_path": ccd[1]},
            cross_correlation={"datasets_to_process": ["I2I1"]}),
            device="cpu")


# --------------------------------------------------- SHT-constraint options
NEG_POINTS = 8


@pytest.fixture
def host_reads(monkeypatch):
    """Counts the JAX package's host reads (one per SHT round trip of
    enforce_sht_constraint, one per particle-number scan)."""
    from xframe_tpu.library import hostio
    count = [0]
    inner = hostio.to_host

    def counting(x):
        count[0] += 1
        return inner(x)
    monkeypatch.setattr(hostio, "to_host", counting)
    return count


@pytest.fixture(scope="module")
def data_proj(extracted):
    """The JAX extract worker's V_l of the pipeline test's CC."""
    return [np.asarray(v) for v in
            extracted[0]["data_projection_matrices"]["I1I1"]]


def _port_sht(l_max):
    from xframe_tpu_torch.ops.fused_sht import FusedSHT
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    return FusedSHT(SphericalHarmonicTransform(l_max, device="cpu"))


def _negative_share(proj, l_max):
    """Σ|min(I, 0)|/Σ|I| of the intensity the V_l synthesize (plain
    float64-accumulated numpy on the JAX package's SHT tables)."""
    from xframe_tpu.ops.sht import SphericalHarmonicTransform
    import jax.numpy as jnp
    n_q = np.atleast_2d(np.asarray(proj[0])).shape[0]
    V = jinv.pad_projection_matrices([np.asarray(p) for p in proj], l_max,
                                     n_q)
    sht = SphericalHarmonicTransform(l_max)
    I = np.asarray(sht.inverse(jnp.asarray(V.astype(np.complex64)))).real
    return float(np.abs(np.minimum(I, 0)).sum() / np.abs(I).sum())


@pytest.mark.parametrize("iterations,limit", [(30, 1e-6), (100, 0.2),
                                              (4, 1e-6)])
def test_enforce_sht_constraint_matches_jax(data_proj, host_reads,
                                            iterations, limit):
    from xframe_tpu.ops.sht import SphericalHarmonicTransform
    pj, cj = jinv.enforce_sht_constraint(
        data_proj, SphericalHarmonicTransform(L_SIM), iterations=iterations,
        rel_err_limit=limit)
    nj = host_reads[0]
    pt, ct, nt = tinv.enforce_sht_constraint(
        [_t(v) for v in data_proj], _port_sht(L_SIM), iterations=iterations,
        rel_err_limit=limit)
    assert (ct, nt) == (cj, nj)
    if limit == 0.2:
        assert ct and nt < iterations
    assert len(pt) == len(pj)
    for a, b in zip(pt, pj):
        assert a.shape == b.shape and a.dtype == torch.complex128
        _close(_gram(a), _gram(b))
    share_j = _negative_share(pj, L_SIM)
    share_t = _negative_share([v.numpy() for v in pt], L_SIM)
    assert abs(share_t - share_j) <= 1e-2 * share_j, (share_t, share_j)


@pytest.mark.parametrize("n_q", [48, 9])
def test_procrustes_orders_equal_the_jax_solution(data_proj, n_q):
    """The Procrustes of every order (orders capped at n_q = 9 batched)
    equals the JAX package's, rank-deficient orders included."""
    rng = np.random.default_rng(2)
    proj = [v[:n_q, : min(v.shape[1], n_q)] for v in data_proj]
    P = jinv.pad_projection_matrices(proj, L_SIM, n_q)
    V = P + 0.1 * (rng.normal(size=P.shape) + 1j * rng.normal(size=P.shape))
    V = V * (np.abs(P).max(axis=0, keepdims=True) > 0)
    got = tinv._procrustes_orders(_t(V), _t(P))
    want = jinv.pad_projection_matrices(
        [p @ jinv.solve_procrustes_problem(v, p) for v, p in zip(
            jinv.unpad_projection_matrices(V),
            jinv.unpad_projection_matrices(P))], L_SIM, n_q)
    _close(got, want)


@pytest.mark.parametrize("method", ["onset", "gradient"])
@pytest.mark.parametrize("with_average", [True, False])
def test_estimate_number_of_particles_matches_jax(extracted, data_proj,
                                                  method, with_average):
    from xframe_tpu.ops.sht import SphericalHarmonicTransform
    avg = np.asarray(extracted[0]["average_intensity"]) if with_average \
        else None
    space = (1.0, 6.0, 41)
    nj, gj, negj, sj = jinv.estimate_number_of_particles(
        data_proj, SphericalHarmonicTransform(L_SIM), search_space=space,
        average_intensity=avg, method=method)
    nt, gt, negt, st = tinv.estimate_number_of_particles(
        [_t(v) for v in data_proj], _port_sht(L_SIM), search_space=space,
        average_intensity=avg, method=method)
    np.testing.assert_array_equal(st, sj)
    size = data_proj[0].shape[0] * np.prod(
        SphericalHarmonicTransform(L_SIM).theta.shape) \
        * SphericalHarmonicTransform(L_SIM).n_phi
    assert np.abs(negt - negj).max() * size <= NEG_POINTS
    assert abs(np.sqrt(nt) - np.sqrt(nj)) <= (sj[1] - sj[0]) + 1e-12


@pytest.mark.parametrize("method", ["onset", "gradient"])
def test_sht_constraint_options_match_jax(ccd, home, host_reads, method):
    """The worker with prephasing (3 × 10 round trips), the optimized
    low-resolution coefficients (max_order 4, 50 iterations) and the
    particle-number estimate, against the JAX worker; the estimate reaches
    the invariants archive."""
    import xframe_tpu as xf
    from xframe_tpu_torch.projects.fxs.store import ProjectStore
    ov = dict(EXTRACT, structure_name="pytest_sht",
              projection_matrices={"prephase": {"apply": True,
                                                "iterations": 3}},
              low_resolution_intensity_approximation={"max_order": 4,
                                                      "n_iterations": 50},
              optimize_projection_matrices={"use": True},
              number_of_particles={"estimate": {
                  "apply": True, "method": method,
                  "search_space": [1.0, 6.0, 41]}})
    xf.select_project("fxs", "extract", overrides=dict(
        ov, structure_name="pytest"))
    want = xf.run()
    reads = host_reads[0]
    got = run_worker("fxs", "extract", overrides=dict(
        ov, input={"ccd_path": ccd[1]}), device="cpu")
    runs = got["sht_constraint"]
    assert runs["prephase"]["iterations"] == 30
    assert runs["low_resolution"]["iterations"] == 50
    assert reads == 30 + 50 + 1
    assert not runs["prephase"]["converged"]
    for a, b in zip(got["data_projection_matrices"]["I1I1"],
                    want["data_projection_matrices"]["I1I1"]):
        _close(_gram(a), _gram(b))
    lt = got["data_low_resolution_intensity_coefficients"]
    lj = want["data_low_resolution_intensity_coefficients"]
    assert sorted(lt, key=int) == sorted(lj, key=int) == list("01234")
    for k in lj:
        _close(_gram(lt[k]), _gram(lj[k]))
    step = 5.0 / 40
    assert abs(np.sqrt(got["number_of_particles"])
               - np.sqrt(want["number_of_particles"])) <= step + 1e-12
    inv = load_invariants(ProjectStore("pytest_sht").path("invariants")[0])
    assert inv["number_of_particles"] == got["number_of_particles"]
    assert "sht_constraint" not in inv
