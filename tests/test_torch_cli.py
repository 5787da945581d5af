"""The port's command line, `python -m xframe_tpu_torch`, in subprocesses
with a throwaway user project: tests/test_framework_cli.py case for case
(the user project's settings with `command:` entries, defaults without a
named file, discovery, `load_projects` as a scalar, `-eset` without `-e`,
the scripting facade), and the port's own: the three settings folders'
precedence, the defaults through the same folders, `--setup_home`'s files
(the SPB experiment's tutorial settings among them), the refusals of
`view` on an archive with nothing to draw, of `-e SPB` without a run
folder and of `--distributed` without torchrun's variables, `--device
cuda` without CUDA, and the JAX
CLI and the port's on the same small simulate_ccd settings (YAML and
JSON): the CC within 1e-4 of max (tests/test_torch_simulate_ccd.py's
bound), the same files in the run folders, .yaml read as .json. `view`
and `-e SPB -eset` on real inputs: tests/test_torch_figures.py and
tests/test_torch_spb.py."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GREET = '''
import os
import numpy as np
from xframe_tpu_torch.interfaces import ProjectWorkerInterface
from xframe_tpu_torch.settings import home_dir


class ProjectWorker(ProjectWorkerInterface):
    def run(self):
        opt = self.settings
        values = np.asarray(opt["values"])
        out = os.path.join(home_dir(), "data", "hello.txt")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(f"{opt['greeting']} sum={values.sum():.1f}")
        print(f"hello worker says: {opt['greeting']} on {self.device.type}")
        return values
'''
GREET_DEFAULTS = {"greeting": {"_value": "default-hi"},
                  "values": {"_value": {"command": "np.arange(4)"}},
                  "scale": {"_value": 1.0}}
LOUD = {"greeting": "HELLO", "values": {"command": "np.arange(5) * 2"}}
SMALL_SIMULATE = {
    "structure_name": "small", "dimensions": 3,
    "grid": {"n_radial_points": 24, "max_order": 10, "max_q": 0.5},
    "shapes": {"types": ["sphere", "sphere"],
               "centers": [[0, 0, 0], [30, 1.2, 0.7]],
               "sizes": [20, 14], "densities": [1.0, 0.7],
               "random_orientation": [False, False]},
    "cross_correlation": {"method": "back_substitution",
                          "xray_wavelength": 1.23984},
}


def _write_json(path, tree):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(tree, f)


@pytest.fixture()
def home(tmp_path):
    proj = tmp_path / "projects" / "hello"
    (proj / "settings" / "greet").mkdir(parents=True)
    (proj / "greet.py").write_text(GREET)
    _write_json(str(proj / "settings" / "greet" / "default_0.1.json"),
                GREET_DEFAULTS)
    _write_json(str(proj / "settings" / "greet" / "loud.json"), LOUD)
    return str(tmp_path)


def _cli(home, *args, module="xframe_tpu_torch"):
    env = dict(os.environ, XFRAME_TPU_HOME=home, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)


def test_cli_runs_user_project(home):
    r = _cli(home, "--device", "cpu", "hello", "greet", "loud")
    assert r.returncode == 0, r.stderr
    assert "hello worker says: HELLO on cpu" in r.stdout
    with open(os.path.join(home, "data", "hello.txt")) as f:
        assert f.read() == "HELLO sum=20.0"  # the command: entry ran


def test_cli_defaults_without_named_settings(home):
    r = _cli(home, "--device", "cpu", "hello", "greet")
    assert r.returncode == 0, r.stderr
    assert "default-hi" in r.stdout
    with open(os.path.join(home, "data", "hello.txt")) as f:
        assert f.read() == "default-hi sum=6.0"


def test_cli_discovery_lists_user_project(home):
    r = _cli(home, "--help")
    assert r.returncode == 0, r.stderr
    for name in ("hello", "fxs", "tutorial", "view"):
        assert name in r.stdout
    r = _cli(home, "fxs", "--help")
    assert r.returncode == 0, r.stderr
    assert "{average,correlate,extract,reconstruct,simulate_ccd}" in r.stdout


@pytest.mark.parametrize("args,item", [
    (["view", "{home}/plain.npz"], "no reconstruction_results or average"),
    (["--device", "cpu", "hello", "greet", "-e", "SPB"], "no run_folder"),
    (["--distributed", "--device", "cpu", "hello", "greet"],
     "RANK is not set"),
])
def test_cli_refusals(home, args, item):
    """What the command line refuses exits non-zero naming why and runs no
    worker: `view` of an archive holding neither reconstructions nor an
    average (the JAX viewer's refusal), `-e SPB` whose settings name no
    run folder, and `--distributed` without torchrun's variables."""
    from xframe_tpu_torch.projects.fxs.store import save_npz
    save_npz(os.path.join(home, "plain.npz"), {"x": np.ones(2)})
    r = _cli(home, *[a.format(home=home) for a in args])
    assert r.returncode != 0
    assert item in r.stderr
    assert not os.path.exists(os.path.join(home, "data", "hello.txt"))


def test_cli_eset_without_experiment_errors(home):
    r = _cli(home, "--device", "cpu", "hello", "greet", "loud", "-eset",
             "my_beamtime")
    assert r.returncode != 0
    assert "-eset" in r.stderr and "--experiment" in r.stderr


def test_cli_cuda_without_cuda_exits_nonzero(home):
    """The default device is the card; without CUDA the worker raises and
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for args in (["hello", "greet"], ["--device", "cuda", "hello", "greet"]):
        r = _cli(home, *args)
        assert r.returncode != 0
        assert "CUDA is not available" in r.stderr
        assert not os.path.exists(os.path.join(home, "data", "hello.txt"))


def test_cli_setup_print_home_and_version(home):
    from xframe_tpu_torch import __version__
    from xframe_tpu_torch.settings import DATA_DIR
    kept = os.path.join(home, "settings", "projects", "fxs", "extract",
                        "tutorial.json")
    _write_json(kept, {"max_order": 3})
    r = _cli(home, "--setup_home")
    assert r.returncode == 0, r.stderr
    for sub in ("settings/projects", "settings/experiments", "data",
                "projects", "cache"):
        assert os.path.isdir(os.path.join(home, sub))
    from xframe_tpu_torch.settings import PACKAGE_DIR
    with open(os.path.join(home, "settings", "experiments", "SPB",
                           "tutorial.json")) as f, \
            open(os.path.join(PACKAGE_DIR, "experiments", "SPB", "settings",
                              "tutorial.json")) as g:
        assert f.read() == g.read()
    for worker in ("simulate_ccd", "extract", "reconstruct", "average",
                   "correlate"):
        got = os.path.join(home, "settings", "projects", "fxs", worker,
                           "tutorial.json")
        with open(got) as f:
            text = f.read()
        with open(os.path.join(DATA_DIR, "fxs", worker,
                               "tutorial.json")) as f:
            want = f.read()
        assert text == want or (got == kept
                                and json.loads(text) == {"max_order": 3})
    r = _cli(home, "--print_home")
    assert r.returncode == 0 and r.stdout.strip() == home
    r = _cli(home, "--version")
    assert r.returncode == 0 and r.stdout.strip() == __version__


def test_scripting_database_facade(monkeypatch, tmp_path):
    """database.project is the selected project's store, rebuilt on each
    selection; named archives round-trip through it."""
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path / "fxs_home"))
    from xframe_tpu_torch import database
    from xframe_tpu_torch.projects.fxs.store import (ProjectStore,
                                                     archive_ext)
    store = database.select_project("fxs", "extract", "tutorial")
    assert store is database.project and isinstance(store, ProjectStore)
    assert store.structure_name == "tutorial"
    assert database.settings["max_order"] == 69
    path = store.path("ccd", run=1)[0]
    assert path.endswith(os.path.join("ccd", "tutorial", "run_1",
                                      "ccd" + archive_ext()))
    data = {"radial_points": np.linspace(0.01, 1.0, 4),
            "angular_points": np.linspace(0, 2 * np.pi, 8, endpoint=False),
            "xray_wavelength": 1.23, "average_intensity": np.ones(4),
            "cross_correlation": {"I1I1": np.ones((4, 4, 8))},
            "num_images_processed": 1, "num_images_good": 1}
    assert store.save("ccd", data) == (path, 1)
    back = store.load_ccd()
    np.testing.assert_array_equal(back["cross_correlation"]["I1I1"],
                                  data["cross_correlation"]["I1I1"])
    assert database.select_project("tutorial", "get_started") is None
    assert database.project is None and database.settings["n_points"] == 64


@pytest.mark.parametrize("wanted,projects", [
    ("hello", {"hello"}), ("fxs", {"fxs"}), (["fxs", "tutorial"],
                                             {"fxs", "tutorial"}),
    ("all", {"fxs", "tutorial", "hello"})])
def test_load_projects(home, monkeypatch, wanted, projects):
    """`load_projects` in <home>/settings/general.json, a scalar or a
    list, filters the projects."""
    from xframe_tpu_torch.main import discover_projects
    from xframe_tpu_torch.settings import load_general_settings
    monkeypatch.setenv("XFRAME_TPU_HOME", home)
    _write_json(os.path.join(home, "settings", "general.json"),
                {"load_projects": wanted, "loglevel": "INFO"})
    found = discover_projects()
    assert set(found) == projects
    if "hello" in found:
        assert found["hello"] == ["greet"]
    if "tutorial" in found:
        assert found["tutorial"] == ["get_started"]
    assert load_general_settings()["loglevel"] == "INFO"


# the folders in which settings `tutorial` of fxs simulate_ccd is written,
# and the one it must come from
PRECEDENCE = [
    (("home", "project"), "home"),
    (("project",), "project"),
    ((), "package"),
]


@pytest.mark.parametrize("folders,winner", PRECEDENCE)
def test_settings_folder_precedence(home, monkeypatch, folders, winner):
    """A bare name is searched in <home>/settings/projects/<p>/<w>, then
    <home>/projects/<p>/settings/<w>, then the package's own folder."""
    from xframe_tpu_torch.settings import load_settings, settings_folders
    monkeypatch.setenv("XFRAME_TPU_HOME", home)
    top, user, package = settings_folders("fxs", "simulate_ccd")
    where = {"home": top, "project": user}
    for name in folders:
        _write_json(os.path.join(where[name], "tutorial.json"),
                    {"structure_name": name})
    s = load_settings("simulate_ccd", "tutorial")
    want = "tutorial" if winner == "package" else winner
    assert s["structure_name"] == want
    assert s["_settings_path"].startswith(
        package if winner == "package" else where[winner])
    # an explicit path wins over every folder
    path = os.path.join(home, "elsewhere", "mine.json")
    _write_json(path, {"structure_name": "explicit"})
    assert load_settings("simulate_ccd", path)["structure_name"] == \
        "explicit"


def test_defaults_through_the_folders(home, monkeypatch):
    """The highest-version default_<ver>.json across the folders completes
    the settings; `settings_version` pins one."""
    from xframe_tpu_torch.settings import load_settings, settings_folders
    monkeypatch.setenv("XFRAME_TPU_HOME", home)
    top = settings_folders("fxs", "simulate_ccd")[0]
    _write_json(os.path.join(top, "default_0.2.json"),
                {"structure_name": {"_value": "from_0.2"},
                 "extra": {"_value": {"command": "int(np.sum([1, 2]))"}}})
    s = load_settings("simulate_ccd")
    assert s["structure_name"] == "from_0.2" and s["extra"] == 3
    assert "grid" not in s
    _write_json(os.path.join(top, "pinned.json"), {"settings_version": 0.1})
    s = load_settings("simulate_ccd", "pinned")
    assert s["structure_name"] == "default_structure" and "grid" in s


@pytest.mark.parametrize("name", ["tutorial.yaml", "/tmp/x/tutorial.yml"])
def test_yaml_settings_refused(name):
    from xframe_tpu_torch.settings import load_settings
    with pytest.raises(ValueError, match="JSON"):
        load_settings("simulate_ccd", name)


def _files(root):
    """{path relative to root: 'link -> target' or 'file'}, .yaml read as
    .json."""
    out = {}
    for folder, _, names in os.walk(root):
        for name in names:
            path = os.path.join(folder, name)
            rel = os.path.relpath(path, root).replace(".yaml", ".json")
            out[rel] = ("link -> " + os.readlink(path)
                        if os.path.islink(path) else "file")
    return out


def test_cli_matches_jax_cli(tmp_path):
    """`xframe-tpu fxs simulate_ccd small` (YAML) and `xframe-tpu-torch
    --device cpu fxs simulate_ccd small` (JSON) in two homes."""
    from xframe_tpu.io import hdf5
    from xframe_tpu_torch.projects.fxs.store import load_archive
    homes = {}
    for pkg, ext in (("xframe_tpu", ".yaml"), ("xframe_tpu_torch", ".json")):
        h = str(tmp_path / pkg)
        path = os.path.join(h, "settings", "projects", "fxs", "simulate_ccd",
                            "small" + ext)
        os.makedirs(os.path.dirname(path))
        with open(path, "w") as f:
            (yaml.safe_dump if ext == ".yaml" else json.dump)(
                SMALL_SIMULATE, f)
        args = ["fxs", "simulate_ccd", "small"]
        if pkg == "xframe_tpu_torch":
            args = ["--device", "cpu"] + args
        r = _cli(h, *args, module=pkg)
        assert r.returncode == 0, r.stderr
        homes[pkg] = os.path.join(h, "data")
    want, got = _files(homes["xframe_tpu"]), _files(homes["xframe_tpu_torch"])
    assert got == want
    assert got["fxs/ccd/small/ccd.h5"] == "link -> run_1/ccd.h5"
    assert "fxs/ccd/small/run_1/model_density.vts" in got
    run = "fxs/ccd/small/run_1/"
    cj = hdf5.load(os.path.join(homes["xframe_tpu"], run, "ccd.h5"))
    ct = load_archive(os.path.join(homes["xframe_tpu_torch"], run, "ccd.h5"))
    a = np.asarray(cj["cross_correlation"]["I1I1"])
    b = ct["cross_correlation"]["I1I1"]
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
    with open(os.path.join(homes["xframe_tpu"], run,
                           "settings_merged.yaml")) as f:
        merged_jax = yaml.safe_load(f)
    with open(os.path.join(homes["xframe_tpu_torch"], run,
                           "settings_merged.json")) as f:
        assert json.load(f) == json.loads(json.dumps(merged_jax))
