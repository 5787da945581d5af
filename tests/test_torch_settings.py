"""The port's worker settings (JSON data, load_settings) equal the JAX
package's YAML settings as xframe_tpu.settings.loader resolves them, for
the five workers, with and without the tutorial settings and the overrides of
tests/test_pipeline_integration.py; the SPB experiment's settings
(load_experiment_settings) equal the JAX loader's, from the package's
files and through the home folders' precedence, and bind the same
ExperimentWorker."""
import json
import os

import numpy as np
import pytest

from xframe_tpu.settings import loader as jloader
from xframe_tpu.settings.loader import load_project_settings

from xframe_tpu_torch.settings import (DATA_DIR, PACKAGE_DIR,
                                       load_experiment_settings,
                                       load_settings)

WORKERS = ["simulate_ccd", "extract", "reconstruct", "average",
           "correlate"]
PIPELINE = {
    "simulate_ccd": {
        "structure_name": "pytest", "dimensions": 3,
        "grid": {"n_radial_points": 48, "max_order": 14, "max_q": 0.5},
        "shapes": {"types": ["sphere", "sphere"],
                   "centers": [[0, 0, 0], [30, 1.2, 0.7]],
                   "sizes": [20, 14], "densities": [1.0, 0.7],
                   "random_orientation": [False, False]},
        "cross_correlation": {"method": "back_substitution",
                              "xray_wavelength": 1.23984},
    },
    "extract": {"structure_name": "pytest", "dimensions": 3,
                "max_order": 14},
    "reconstruct": {
        "structure_name": "pytest", "dimensions": 3, "particle_radius": 50,
        "grid": {"n_radial_points": 24, "max_order": 10},
        "multi_start": {"n_reconstructions": 3, "seed": 7},
        "main_loop": {"sub_loops": {
            "order": ["main", "refinement"],
            "main": {"iterations": 2, "order": ["HIO", "SW", "ER"],
                     "methods": {"HIO": {"iterations": 15},
                                 "SW": {"iterations": 1},
                                 "ER": {"iterations": 10}}},
            "refinement": {"iterations": 1, "order": ["SW_center", "ER"],
                           "methods": {"SW_center": {"iterations": 1},
                                       "ER": {"iterations": 15}}}}},
        "projections": {"real": {
            "shrink_wrap": {"sigmas": [False, False],
                            "thresholds": [0.09, 0.09]},
            "HIO": {"beta": [[0.5, 0.4, -1 / 50, 100],
                             [0.01, 0.002, -1 / 50, 50]]}}},
    },
    "average": {
        "structure_name": "pytest",
        "selection": {"method": "least_error", "error_limit": 1.0,
                      "n_reconstructions": "all"},
        "l2_error_limit": 2.0,
        "resolution_metrics": {"PRTF": True, "FSC": True, "FQCB": True},
    },
    # tests/test_correlate.py's option wiring
    "correlate": {
        "structure_name": "corr_opt_test", "image_dimensions": [64, 64],
        "detector_origin": [31.5, 31.5],
        "polar_grid": {"n_phi": 64, "n_q": 16}, "batch_size": 3,
        "qrange_xcca": [[0.0, 1.0, 1], [0.0, 1.0, 1]],
        "phi_range": [0.0, 6.283185307179586], "ccf_2p_symmetrize": True,
        "refine_beam_center": {"search_radius_pix": 1.0, "steps": 3},
        "filters": {"radial_pixel_filter": ["average_sigma", 6.0],
                    "roi": {"q_range": [0.005, 0.02], "normalize": True,
                            "mean_bounds": [1e-8, 1e8]}},
        "corrections": {"polarization": "v", "solid_angle": True},
    },
}
# overrides that switch the defaults' _only_if and _copy directives
DIRECTIVES = {
    "simulate_ccd": {"noise": {"apply": True}, "grid": {"max_q": False}},
    "extract": {"extraction_mode": "shapes",
                "cross_correlation": {"datasets": {"I1I1": {"bl_q_limits": {
                    "min": {"type": "line"}}}}},
                "invariant_constraints": {"q_limits": {"type": "manual"}},
                "projection_matrices": {"prephase": {"apply": True}}},
    "reconstruct": {"density_guess": {"type": "ball",
                                      "amplitude_function": "uniform"},
                    "particle_radius": 77,
                    "projections": {"reciprocal": {"q_mask": {
                        "type": "manual",
                        "manual": {"type": "order_dependent_line"}}}}},
    "average": {"selection": {"method": "manual"}, "use_masks": True},
    "correlate": {"polar_grid": {"phi_sampling_mode": "max"},
                  "filters": {"radial_pixel_filter": ["median_mad", 3.0]},
                  "input": {"dtype": "uint16"}},
}


def _plain(x):
    """Settings tree → comparable plain values, '_' keys dropped, arrays
    and tuples as lists."""
    if hasattr(x, "dict") and not isinstance(x, dict):
        x = x.dict()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()
                if not str(k).startswith("_")}
    if isinstance(x, np.ndarray):
        x = x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.mark.parametrize("worker", WORKERS)
@pytest.mark.parametrize("name", [None, "tutorial"])
@pytest.mark.parametrize("overrides", [None, PIPELINE, DIRECTIVES])
def test_settings_equal_jax_loader(worker, name, overrides):
    ov = None if overrides is None else overrides[worker]
    want = _plain(load_project_settings("fxs", worker, name, overrides=ov)[0])
    got = load_settings(worker, name, ov)
    assert _plain(got) == want


@pytest.mark.parametrize("worker", WORKERS)
def test_settings_data_are_plain_json(worker):
    """No documentation keys, no unevaluated commands in the data."""
    def walk(x):
        if isinstance(x, dict):
            assert "_description" not in x and "_possible_values" not in x
            assert "command" not in x
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
    for name in ("default_0.1", "tutorial"):
        with open(os.path.join(DATA_DIR, "fxs", worker, name + ".json")) as f:
            walk(json.load(f))


def test_tutorial_commands_are_evaluated():
    s = load_settings("reconstruct", "tutorial")
    assert s["projections"]["real"]["HIO"]["beta"] == [
        [0.5, 0.4, -1 / 250, 500], [0.01, 0.002, -1 / 200, 200]]
    assert s["projections"]["reciprocal"]["used_order_ids"] == \
        list(range(65))
    assert s["multi_start"] == {"n_reconstructions": 8, "seed": False,
                                "batch_size": 2, "results_to_keep": "all"}


def test_simulate_tutorial_commands_are_evaluated():
    s = load_settings("simulate_ccd", "tutorial")
    assert s["shapes"]["types"] == ["sphere"] * 6
    assert s["shapes"]["centers"][0] == [0, 0, 0]
    assert s["grid"] == {"max_q": 0.322416, "n_radial_points": 512,
                         "max_order": 128, "oversampling": 8, "n_phi": 0,
                         "n_theta": 0, "n_phi_internal": 0}
    assert load_settings("extract", "tutorial")["max_order"] == 69
    c = load_settings("correlate", "tutorial")
    assert c["max_n_patterns"] == 2000 and c["polar_grid"] == {
        "n_phi": 1024, "n_q": 0, "phi_sampling_mode": False}
    assert c["detector_origin"] == [255.2, 255.5] and c["fc_n_max"] == 70


WORKERS_2D = ["simulate_ccd", "extract", "reconstruct", "average"]


@pytest.mark.parametrize("worker", WORKERS_2D)
def test_tutorial_2d_settings_equal_jax_loader(worker):
    """The four tutorial_2d.json files merge to the JAX loader's trees."""
    want = _plain(load_project_settings("fxs", worker, "tutorial_2d")[0])
    got = load_settings(worker, "tutorial_2d")
    assert _plain(got) == want
    assert got["structure_name"] == "tutorial_2d"
    with open(os.path.join(DATA_DIR, "fxs", worker,
                           "tutorial_2d.json")) as f:
        assert "command" not in json.dumps(json.load(f))


def test_tutorial_2d_commands_are_evaluated():
    s = load_settings("simulate_ccd", "tutorial_2d")
    assert s["dimensions"] == 2 and s["shapes"]["types"] == ["sphere"] * 6
    assert s["shapes"]["centers"][0] == [0, 0]
    assert s["shapes"]["centers"][2] == pytest.approx([140.0, 2 * np.pi / 5])
    assert s["grid"]["n_phi"] == 256 and s["grid"]["max_order"] == 64
    r = load_settings("reconstruct", "tutorial_2d")
    assert r["projections"]["reciprocal"]["SO_freedom"]["apply"] is True
    assert r["projections"]["real"]["HIO"]["beta"] == [
        [0.5, 0.4, -1 / 250, 500], [0.01, 0.002, -1 / 200, 200]]
    assert load_settings("average", "tutorial_2d")["l2_error_limit"] == 0.6


def test_tutorial_project_settings_equal_jax_loader():
    """The tutorial project's get_started defaults, as JSON, merge to the
    JAX loader's tree, alone and under overrides."""
    for ov in (None, {"n_points": 16, "radius": 4.5}):
        want = _plain(load_project_settings("tutorial", "get_started", None,
                                            overrides=ov)[0])
        got = load_settings("get_started", None, ov, project="tutorial")
        assert _plain(got) == want
    with open(os.path.join(DATA_DIR, "tutorial", "get_started",
                           "default_0.1.json")) as f:
        assert "_description" not in json.dumps(json.load(f))


def test_unknown_settings_raise():
    with pytest.raises(FileNotFoundError):
        load_settings("reconstruct", "no_such_settings")


EXPERIMENT_OVERRIDES = {"run_folder": "/data/r0001", "bad_cells": [0],
                        "filter_sequence": ["adu"]}


@pytest.mark.parametrize("name", [None, "tutorial"])
@pytest.mark.parametrize("overrides", [None, EXPERIMENT_OVERRIDES])
def test_experiment_settings_equal_jax_loader(name, overrides):
    want = _plain(jloader.load_experiment_settings("SPB", name,
                                                   overrides=overrides)[0])
    got = load_experiment_settings("SPB", name, overrides)
    assert _plain(got) == want
    assert ("wavelength" in got) == (name is None)
    if name == "tutorial":
        assert got["good_cells"] == list(range(1, 352))
    for f in ("default_0.01", "tutorial"):
        with open(os.path.join(PACKAGE_DIR, "experiments", "SPB", "settings",
                               f + ".json")) as fh:
            assert "command" not in json.dumps(json.load(fh))


# tests/test_experiment_settings.py's home file, as YAML and as JSON
MYEXP = {"x_ray_energy": 8000, "detector_distance": 0.285,
         "good_cells": {"command": "np.arange(1, 6)"},
         "filter_sequence": ["adu"],
         "filters": {"adu": {"class": "ADUFilter", "limits": [-40, 4000]}}}


@pytest.mark.parametrize("where", ["settings/experiments/SPB",
                                   "experiments/SPB/settings"])
def test_experiment_settings_from_the_home_folders(tmp_path, monkeypatch,
                                                   where):
    """A home file in either experiment folder wins over the package's
    (the same precedence as the JAX loader's), and binds an
    ExperimentWorker equal to the JAX one."""
    import yaml
    import h5py
    from xframe_tpu.experiments.SPB import experiment as jexp
    from xframe_tpu_torch.experiments.SPB import experiment as texp
    run = tmp_path / "run"
    run.mkdir()
    for mod in range(2):
        with h5py.File(run / f"RAW-R1-AGIPD{mod:02d}-S00000.h5", "w") as f:
            grp = f"INSTRUMENT/SPB_DET_AGIPD1M-1/DET/{mod}CH0:xtdf/image"
            f.create_dataset(f"{grp}/data",
                             data=np.full((6, 512, 128), 3.0, np.float32))
            f.create_dataset(f"{grp}/cellId",
                             data=np.arange(6, dtype=np.uint16))
    folder = tmp_path / where
    folder.mkdir(parents=True)
    tree = dict(MYEXP, run_folder=str(run))
    (folder / "myexp.yaml").write_text(yaml.safe_dump(tree))
    (folder / "myexp.json").write_text(json.dumps(tree))
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    want = jloader.load_experiment_settings("SPB", "myexp")[0]
    got = load_experiment_settings("SPB", "myexp")
    assert _plain(got) == _plain(want)
    assert got["_settings_path"] == str(folder / "myexp.json")
    assert list(got["good_cells"]) == [1, 2, 3, 4, 5]
    tw = texp.ExperimentWorker.from_settings(got)
    jw = jexp.ExperimentWorker.from_settings(want)
    assert tw.wavelength == jw.wavelength
    assert np.array_equal(tw.index.frame_mask, jw.index.frame_mask)
    assert tw.index.frame_mask.sum() == 5
    assert [type(f).__name__ for f in tw.filter_sequence.filters] == \
        ["ADUFilter"]
    assert texp.ExperimentWorker.from_settings(
        got, wavelength=2.0).wavelength == 2.0
