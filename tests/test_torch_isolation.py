"""The port runs without JAX, PyYAML or the JAX package (a two-rank CPU
device mesh included), imports h5py and matplotlib only where it reads or
writes HDF5 or draws, runs where neither is installed (writing `.npz`
archives and one line naming each missing package), and never falls back
to the CPU when a GPU was asked for."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
from xframe_tpu_torch.projects.fxs.phasing import Segment

REPO = Path(__file__).resolve().parents[1]

# every module of the port, imported in a fresh interpreter
_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import xframe_tpu_torch
for _m in pkgutil.walk_packages(xframe_tpu_torch.__path__,
                                "xframe_tpu_torch."):
    if not _m.name.endswith("__main__"):
        importlib.import_module(_m.name)
print("LAZY", sorted(m for m, mod in sys.modules.items()
                     if m.split(".")[0] in ("h5py", "matplotlib")
                     and mod is not None))
"""

_CHILD = _IMPORT_ALL + """
import numpy as np, torch
import xframe_tpu_torch.ops.fused_mtip
import xframe_tpu_torch.ops.fused_projection
import xframe_tpu_torch.convert
import xframe_tpu_torch.ops.so3
from xframe_tpu_torch.parallel.mesh import MultiStartRunner
from xframe_tpu_torch.projects.fxs.alignment import Aligner
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
from xframe_tpu_torch.projects.fxs.fidelity import align_to_ground_truth
from xframe_tpu_torch.projects.fxs.phasing import MTIP, Segment
p = make_demo_problem(8, 4, fused_sht=True, procrustes_method="newton_schulz",
                      device="cpu")
rho0 = p.initial_density_batch(0, 2)
state, errors = p.mtip.run_batch(
    rho0, [Segment("HIO", 1, betas=np.full(1, 0.5), ft_stab=True)])
assert errors.shape == (2, 1, 2) and bool(torch.isfinite(errors).all())
assert p.mtip._fi is not None
m = p.mtip
replay = MTIP(p.ft, m.rc, m.real, m.sw, p.integrator.w_broadcast.numpy(),
              p.initial_support, best_mode="replay", device="cpu")
state, errors = MultiStartRunner(
    replay, [Segment("HIO", 3, betas=np.full(3, 0.5), ft_stab=True)])(rho0)
corr = align_to_ground_truth(state.best_rho[0], p.shapes, p.ft,
                             p.integrator.w_broadcast)[0]
assert np.isfinite(corr)
import os, tempfile
import xframe_tpu_torch.settings
from xframe_tpu_torch.main import run_worker
from xframe_tpu_torch.projects.fxs import (average, extract, reconstruct,
                                           resolution_metrics,
                                           simulate_ccd, store)
import xframe_tpu_torch.library.pdb
home = tempfile.mkdtemp()
os.environ["XFRAME_TPU_HOME"] = home
ccd = run_worker("fxs", "simulate_ccd", overrides={
    "grid": {"n_radial_points": 8, "max_order": 4, "max_q": 0.5},
    "shapes": {"types": ["sphere"], "centers": [[0, 0, 0]], "sizes": [20],
               "densities": [1.0]}}, device="cpu")
assert np.isfinite(ccd["cross_correlation"]["I1I1"]).all()
ex = run_worker("fxs", "extract", overrides={"max_order": 4}, device="cpu")
assert len(ex["data_projection_matrices"]["I1I1"]) == 5
inv = os.path.join(home, "inv.npz")
store.save_npz(inv, {"data_radial_points": p.ft.qs, "max_order": 4,
                     "data_projection_matrices":
                         {"I1I1": p.projection_matrices},
                     "average_intensity": p.average_intensity,
                     "xray_wavelength": 1.0})
res = run_worker("fxs", "reconstruct", overrides={
    "particle_radius": float(p.radius * 1.2),
    "grid": {"n_radial_points": 8, "max_order": 4},
    "input": {"invariants_path": inv},
    "multi_start": {"n_reconstructions": 2, "batch_size": 1, "seed": 0},
    "main_loop": {"sub_loops": {"order": ["main"], "main": {
        "iterations": 1, "order": ["HIO", "SW_center", "ER"],
        "methods": {"HIO": {"iterations": 2}, "SW_center": {"iterations": 1},
                    "ER": {"iterations": 2}}}}}}, device="cpu")
assert len(res["reconstruction_results"]) == 2
# the device mesh: two gloo ranks on the CPU, spawned from here
mres = run_worker("fxs", "reconstruct", overrides={
    "structure_name": "mesh", "particle_radius": float(p.radius * 1.2),
    "grid": {"n_radial_points": 8, "max_order": 4},
    "input": {"invariants_path": inv}, "mesh": {"restarts": 2},
    "multi_start": {"n_reconstructions": 3, "batch_size": 0, "seed": 0},
    "main_loop": {"sub_loops": {"order": ["main"], "main": {
        "iterations": 1, "order": ["HIO", "SW", "ER"],
        "methods": {"HIO": {"iterations": 2}, "SW": {"iterations": 1},
                    "ER": {"iterations": 2}}}}}}, device="cpu",
    devices=["cpu", "cpu"])
assert len(mres["reconstruction_results"]) == 3
avg = run_worker("fxs", "average", overrides={
    "selection": {"error_limit": 10.0},
    "resolution_metrics": {"FSC": True, "FQCB": True}}, device="cpu")
assert np.isfinite(avg["average"]["real_density"]).all()
from xframe_tpu_torch.experiments.SPB.detectors.agipd import AGIPD
from xframe_tpu_torch.native import PrefetchingFrameLoader
from xframe_tpu_torch.projects.fxs.correlate import Correlator
paths = []
for i in range(3):
    f = np.random.default_rng(i).uniform(1, 2, (24, 24)).astype(np.float32)
    paths.append(os.path.join(home, f"f{i}.raw"))
    f.tofile(paths[-1])
corr = Correlator((24, 24), (11.5, 11.5), 200.0, 800.0, 1.0, n_phi=16,
                  n_q=6, radial_pixel_filter=("median_mad", 3.0),
                  device="cpu")
out = corr.correlate_frames(PrefetchingFrameLoader(paths, (24, 24),
                                                   batch_size=2))
assert out["num_images_good"] == 3
assert np.isfinite(out["cross_correlation"]).all()
assert AGIPD().pixel_centers.shape == (16, 512, 128, 3)
import xframe_tpu_torch.database
import xframe_tpu_torch.interfaces
import xframe_tpu_torch.io.vtk
from xframe_tpu_torch.main import main
from xframe_tpu_torch.projects.tutorial import get_started
assert main(["--device", "cpu", "tutorial", "get_started"]) == 0
assert os.path.exists(os.path.join(home, "data", "tutorial", "run_1",
                                   "result" + store.archive_ext()))
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "yaml", "xframe_tpu"))
print("BANNED", banned)
"""


def test_port_imports_no_jax_yaml_or_reference_package():
    """One CPU iteration in a fresh interpreter (-I: no PYTHONPATH, no user
    site), as on a machine that has neither JAX nor PyYAML."""
    out = subprocess.run([sys.executable, "-I", "-c", _CHILD, str(REPO)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BANNED []" in out.stdout, out.stdout
    assert "LAZY []" in out.stdout, out.stdout


_BLOCKED = """
import sys
sys.modules["h5py"] = None
sys.modules["matplotlib"] = None
""" + _IMPORT_ALL + """
import os, tempfile
import numpy as np
from xframe_tpu_torch.main import run_worker
from xframe_tpu_torch.projects.fxs import store
from xframe_tpu_torch.projects.fxs.demo import make_demo_problem
home = tempfile.mkdtemp()
os.environ["XFRAME_TPU_HOME"] = home
p = make_demo_problem(8, 4, device="cpu")
inv = os.path.join(home, "inv.npz")
store.save_npz(inv, {"data_radial_points": p.ft.qs, "max_order": 4,
                     "data_projection_matrices":
                         {"I1I1": p.projection_matrices},
                     "average_intensity": p.average_intensity,
                     "xray_wavelength": 1.0})
res = run_worker("fxs", "reconstruct", overrides={
    "structure_name": "blocked", "particle_radius": float(p.radius * 1.2),
    "grid": {"n_radial_points": 8, "max_order": 4},
    "input": {"invariants_path": inv},
    "multi_start": {"n_reconstructions": 2, "seed": 0},
    "main_loop": {"sub_loops": {"order": ["main"], "main": {
        "iterations": 1, "order": ["HIO", "SW", "ER"],
        "methods": {"HIO": {"iterations": 2}, "SW": {"iterations": 1},
                    "ER": {"iterations": 2}}}}}}, device="cpu")
run = os.path.join(home, "data", "fxs", "reconstructions", "blocked",
                   "run_1")
print("FILES", sorted(f for f in os.listdir(run)
                      if f.endswith((".npz", ".h5", ".png"))))
assert "h5py" not in sys.modules or sys.modules["h5py"] is None
"""


def test_port_runs_with_h5py_and_matplotlib_blocked():
    """As on a machine that has neither h5py nor matplotlib: every module
    imports, and the reconstruct worker writes data.npz, no figure, and a
    line naming each package."""
    out = subprocess.run([sys.executable, "-I", "-c", _BLOCKED, str(REPO)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LAZY []" in out.stdout, out.stdout
    assert "FILES ['data.npz']" in out.stdout, out.stdout
    assert "data.h5: h5py is not installed; wrote data.npz in its place" \
        in out.stdout, out.stdout
    assert "reconstructions: figures not written (errors.png, " \
        "first_used_invariants.png, real_density_0.png, " \
        "real_density_1.png): matplotlib is not installed" in out.stdout, \
        out.stdout


def test_cuda_demo_problem_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_demo_problem(8, 4, fused_sht=True, device="cuda")


def test_entry_points_default_to_cuda():
    """Without a device the entry points ask for the card: on a machine
    without CUDA make_demo_problem raises."""
    import inspect
    from xframe_tpu_torch.ops.fourier import SphericalFourierTransform
    from xframe_tpu_torch.projects.fxs.phasing import MTIP
    from xframe_tpu_torch.projects.fxs.projections import (
        ReciprocalConstraint, ShrinkWrap)
    from xframe_tpu_torch.main import run_worker, select_worker
    from xframe_tpu_torch.projects.fxs import (average, correlate, extract,
                                               reconstruct, simulate_ccd)
    from xframe_tpu_torch.interfaces import ProjectWorkerInterface
    from xframe_tpu_torch.projects.tutorial import get_started
    for fn in (ProjectWorkerInterface, get_started.ProjectWorker,
               make_demo_problem, MTIP, ReciprocalConstraint.build,
               ReciprocalConstraint.from_numpy, ShrinkWrap.build,
               SphericalFourierTransform, run_worker, select_worker,
               simulate_ccd.ProjectWorker,
               simulate_ccd.device_density_from_shapes,
               extract.ProjectWorker, reconstruct.ProjectWorker,
               average.ProjectWorker, correlate.ProjectWorker,
               correlate.Correlator, correlate.PanelCorrelator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_demo_problem()
    for worker in ("correlate", "simulate_ccd", "extract", "reconstruct",
                   "average"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            select_worker("fxs", worker)


def test_transforms_always_go_through_fused_sht():
    """The settings choose the transforms: the kernel wrappers (FusedSHT)
    by default, the plain SphericalHarmonicTransform under fused_sht=False
    or float64; nothing launches on the CPU either way."""
    from xframe_tpu_torch.ops import fused_mtip, fused_projection
    from xframe_tpu_torch.ops.fused_sht import FusedSHT, METHODS
    from xframe_tpu_torch.ops.sht import SphericalHarmonicTransform
    seg = [Segment("HIO", 2, betas=np.full(2, 0.5), ft_stab=True)]
    fused_projection.reset_launches()
    for kw, kernels in (({}, True), ({"fused_sht": False}, False),
                        ({"real_dtype": torch.float64}, False)):
        p = make_demo_problem(8, 4, procrustes_method="newton_schulz_pallas",
                              device="cpu", **kw)
        assert p.mtip.sht is p.ft.harmonic
        assert isinstance(p.ft.harmonic, FusedSHT) == kernels
        assert (p.mtip._fi is not None) == kernels
        if not kernels:
            assert type(p.ft.harmonic) is SphericalHarmonicTransform
        p.mtip.run_batch(p.initial_density_batch(0, 2), seg)
        if kernels:
            assert p.ft.harmonic.launches == dict.fromkeys(METHODS, 0)
            assert p.mtip._fi.launches == dict.fromkeys(fused_mtip.METHODS,
                                                        0)
    assert fused_projection.launches == dict.fromkeys(
        fused_projection.METHODS, 0)


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line without a
    GPU, and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_unported_schedule_features_raise():
    """Once refused: a linked ft-stab segment runs; before any shrink-wrap
    its gate is shut, so it gives the errors without ft-stab."""
    p = make_demo_problem(8, 4, device="cpu")
    rho0 = p.initial_density_batch(0, 1)
    state, linked = p.mtip.run_batch(rho0, [Segment(
        "HIO", 1, betas=np.ones(1), ft_stab=True, ft_stab_link_delay=2)])
    assert state.enforce_hist.shape == (1, 2)
    _, off = p.mtip.run_batch(rho0, [Segment("HIO", 1, betas=np.ones(1),
                                             ft_stab=False)])
    assert torch.allclose(linked, off, rtol=1e-5, atol=0)
