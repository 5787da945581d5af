"""The command line and the entry points of the port: the counterpart of
`xframe_tpu.main`, `xframe_tpu.select_project` and `xframe_tpu.run`.

    python -m xframe_tpu_torch [--device cpu|cuda:N] <project> <worker>
                               [settings] [-e <experiment> [-eset <settings>]]
    torchrun --nproc-per-node 2 -m xframe_tpu_torch --distributed \
        fxs reconstruct tutorial
    python -m xframe_tpu_torch view <archive> [-o DIR] [-n N]
    python -m xframe_tpu_torch --setup_home | --print_home | --version

    from xframe_tpu_torch.main import run_worker
    run_worker("fxs", "correlate", "tutorial")      # detector frames → ccd
    run_worker("fxs", "simulate_ccd", "tutorial")   # or a synthetic ccd
    run_worker("fxs", "extract", "tutorial")
    results = run_worker("fxs", "reconstruct", "tutorial",
                         overrides={"multi_start": {"seed": 0}})
    average = run_worker("fxs", "average", "tutorial")

A project is a package under xframe_tpu_torch.projects or a folder
<home>/projects/<name>/ of `<worker>.py` files; a worker is a module that
defines `ProjectWorker(settings, device)` with a `run()` method. Workers
run on the card unless the caller passes device="cpu" (`--device cpu`);
asking for a CUDA device where none exists raises. On the bare "cuda" the
reconstruct and average workers spread their restarts and candidates over
every visible card (their `mesh` settings); "cuda:N" keeps them on card
N. `--distributed` joins the ranks that torchrun started (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): each takes
cuda:LOCAL_RANK (the CPU under `--device cpu`), the mesh spans WORLD_SIZE
ranks, and a worker without a mesh runs on rank 0 alone. Settings are found
through the home folder first (xframe_tpu_torch.settings); files live
under XFRAME_TPU_HOME (projects/fxs/store.py). `-e` binds an experiment
(`comm.select_experiment`) from its settings `-eset`, the worker settings'
`experiment` block overriding them; `view` draws an archive
(presenters/viewer.py).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import logging
import os
import pkgutil
import shutil
import sys

from xframe_tpu_torch.settings import (DATA_DIR, PACKAGE_DIR, home_dir,
                                       load_general_settings, load_settings)

WORKER_CLASS = "ProjectWorker"


def _builtin_workers(project):
    """The modules of package xframe_tpu_torch.projects.<project> that
    define a ProjectWorker."""
    pkg = importlib.import_module(f"xframe_tpu_torch.projects.{project}")
    return sorted(
        m.name for m in pkgutil.iter_modules(pkg.__path__)
        if not m.ispkg and not m.name.startswith("_") and hasattr(
            importlib.import_module(f"{pkg.__name__}.{m.name}"),
            WORKER_CLASS))


def discover_projects():
    """{project: [workers]}: the port's projects, then user projects under
    <home>/projects/ (each `<worker>.py` not starting with '_'), filtered
    by the general setting load_projects ('all', a name or a list)."""
    import xframe_tpu_torch.projects as pkg
    found = {}
    for mod in pkgutil.iter_modules(pkg.__path__):
        if mod.ispkg:
            workers = _builtin_workers(mod.name)
            if workers:
                found[mod.name] = workers
    home_projects = os.path.join(home_dir(), "projects")
    if os.path.isdir(home_projects):
        for name in sorted(os.listdir(home_projects)):
            path = os.path.join(home_projects, name)
            if os.path.isdir(path):
                workers = sorted(
                    f[:-3] for f in os.listdir(path)
                    if f.endswith(".py") and not f.startswith("_"))
                if workers:
                    found.setdefault(name, workers)
    wanted = load_general_settings()["load_projects"]
    if isinstance(wanted, str) and wanted != "all":
        wanted = [wanted]
    if wanted != "all" and isinstance(wanted, (list, tuple)):
        found = {k: v for k, v in found.items() if k in wanted}
    return found


def _project_help(project):
    """(description, {worker: (short, long)}) from the project's
    _argparser_ module, where it has one."""
    try:
        mod = importlib.import_module(
            f"xframe_tpu_torch.projects.{project}._argparser_")
    except ModuleNotFoundError:
        return None, {}
    return (getattr(mod, "PROJECT_DESCRIPTION", None),
            getattr(mod, "WORKER_HELP", {}))


def setup_home(path=None):
    """Create the home folder tree and copy each worker's tutorial.json
    into <home>/settings/projects/<project>/<worker>/, and each
    experiment's into <home>/settings/experiments/<experiment>/, as a
    starting point to edit (an existing copy is kept). → the home
    folder."""
    home = path or home_dir()
    for sub in ("settings/projects", "settings/experiments", "data",
                "projects", "cache"):
        os.makedirs(os.path.join(home, sub), exist_ok=True)
    exp_root = os.path.join(PACKAGE_DIR, "experiments")
    for exp in sorted(os.listdir(exp_root)):
        src = os.path.join(exp_root, exp, "settings", "tutorial.json")
        dst = os.path.join(home, "settings", "experiments", exp,
                           "tutorial.json")
        if os.path.exists(src) and not os.path.exists(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(src, dst)
    for project in sorted(os.listdir(DATA_DIR)):
        pdir = os.path.join(DATA_DIR, project)
        if not os.path.isdir(pdir):
            continue
        for worker in sorted(os.listdir(pdir)):
            src = os.path.join(pdir, worker, "tutorial.json")
            if os.path.exists(src):
                dst_dir = os.path.join(home, "settings", "projects", project,
                                       worker)
                os.makedirs(dst_dir, exist_ok=True)
                dst = os.path.join(dst_dir, "tutorial.json")
                if not os.path.exists(dst):
                    shutil.copy(src, dst)
    print(f"xframe_tpu_torch home initialized at {home}")
    return home


def _worker_module(project, worker):
    """xframe_tpu_torch.projects.<project>.<worker>, else the user
    project's <home>/projects/<project>/<worker>.py."""
    name = f"xframe_tpu_torch.projects.{project}.{worker}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as exc:
        if exc.name not in (name, f"xframe_tpu_torch.projects.{project}"):
            raise
    path = os.path.join(home_dir(), "projects", project, f"{worker}.py")
    if not os.path.exists(path):
        raise ValueError(f"no worker {worker!r} in project {project!r}: "
                         f"neither {name} nor {path} exists")
    spec = importlib.util.spec_from_file_location(
        f"xframe_tpu_torch_user.{project}.{worker}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def select_worker(project, worker, settings_name=None, overrides=None,
                  device="cuda", **mesh_kw):
    """The worker `worker` of `project` (the port's or a user project's)
    with its merged settings. mesh_kw (`devices`, `mesh`) go to a worker
    that spreads over a mesh (`uses_mesh`)."""
    module = _worker_module(project, worker)
    cls = getattr(module, WORKER_CLASS, None)
    if cls is None:
        raise ValueError(f"{project} {worker}: the module defines no "
                         f"{WORKER_CLASS}")
    if mesh_kw and not getattr(cls, "uses_mesh", False):
        raise ValueError(f"{project} {worker} runs on one device: it takes "
                         f"no {sorted(mesh_kw)}")
    settings = load_settings(worker, settings_name, overrides,
                             project=project)
    return cls(settings, device=device, **mesh_kw)


def run_worker(project, worker, settings_name=None, overrides=None,
               device="cuda", **mesh_kw):
    """Select and run a worker. → its results (None on a mesh rank other
    than 0)."""
    return select_worker(project, worker, settings_name, overrides,
                         device=device, **mesh_kw).run()


TORCHRUN_VARIABLES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                      "MASTER_PORT")


def distributed_mesh(device):
    """--distributed: the mesh of the ranks that torchrun started, from its
    variables; a missing one exits naming it."""
    from xframe_tpu_torch.parallel.mesh import world_mesh
    for name in TORCHRUN_VARIABLES:
        if name not in os.environ:
            raise SystemExit(
                f"--distributed: {name} is not set; start the command with "
                "torchrun, which sets " + ", ".join(TORCHRUN_VARIABLES))
    return world_mesh(os.environ["RANK"], os.environ["WORLD_SIZE"],
                      os.environ["LOCAL_RANK"], device)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="xframe-tpu-torch",
        description="The FXS reconstruction framework on PyTorch and CUDA")
    parser.add_argument("--setup_home", action="store_true",
                        help="create the home folder tree and exit")
    parser.add_argument("-d", "--debug", action="store_true",
                        help="verbose logging")
    parser.add_argument("--distributed", action="store_true",
                        help="join the ranks that torchrun started (RANK, "
                             "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT): rank r on cuda:LOCAL_RANK (the "
                             "CPU under --device cpu); reconstruct and "
                             "average spread over the WORLD_SIZE ranks "
                             "(reconstruct's mesh.theta T on the plain "
                             "path: WORLD_SIZE/T restart groups of T θ "
                             "ranks), other workers run on rank 0")
    parser.add_argument("--print_home", action="store_true")
    parser.add_argument("--version", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the worker (default cuda: "
                             "reconstruct and average spread over every "
                             "visible card; cuda:N runs on card N; cpu "
                             "runs the kernels' plain versions)")
    sub = parser.add_subparsers(dest="project")
    vp = sub.add_parser("view", help="render a reconstructions or average "
                                     "archive to PNG (headless viewer)")
    vp.add_argument("file", help="reconstructions or average archive "
                                 "(.h5 or .npz)")
    vp.add_argument("-o", "--out", default=None, help="output folder "
                    "(default: next to the archive)")
    vp.add_argument("-n", "--max-results", type=int, default=4)
    for project, workers in discover_projects().items():
        desc, whelp = _project_help(project)
        p = sub.add_parser(project, help=desc, description=desc)
        ws = p.add_subparsers(dest="worker")
        for w in workers:
            short, long_ = whelp.get(w, (None, None))
            wp = ws.add_parser(w, help=short, description=long_)
            wp.add_argument("settings", nargs="?", default=None,
                            help="settings name (resolved through the "
                                 "settings folder precedence) or a .json path")
            wp.add_argument("-e", "--experiment", default=None,
                            help="experiment to bind for comm.get_data "
                                 "(e.g. SPB)")
            wp.add_argument("-eset", "--experiment_settings", default=None,
                            metavar="FILE_NAME",
                            help="experiment settings name, resolved "
                                 "through the experiment settings "
                                 "folders (requires -e)")

    args = parser.parse_args(argv)
    logging.basicConfig(level="DEBUG" if args.debug else str(
        load_general_settings()["loglevel"]).upper())
    if args.version:
        import xframe_tpu_torch
        print(xframe_tpu_torch.__version__)
        return 0
    if args.setup_home:
        setup_home()
        return 0
    if args.print_home:
        print(home_dir())
        return 0
    if args.project == "view":
        from xframe_tpu_torch.projects.fxs import figures
        if not figures.available():
            raise SystemExit(f"view: {figures.MISSING}; the viewer draws "
                             "with matplotlib")
        from xframe_tpu_torch.presenters.viewer import view_file
        for p in view_file(args.file, out_dir=args.out,
                           max_results=args.max_results):
            print(p)
        return 0
    if not args.project or not getattr(args, "worker", None):
        parser.print_help()
        return 1
    if args.experiment_settings and not args.experiment:
        raise SystemExit(
            f"-eset {args.experiment_settings!r} requires -e/--experiment "
            "to select the experiment module it configures")
    if not args.distributed:
        return _run_cli_worker(args, args.device)
    import torch.distributed as dist
    mesh = distributed_mesh(args.device)
    try:
        return _run_cli_worker(args, mesh.device, mesh=mesh)
    finally:
        dist.destroy_process_group()


def _run_cli_worker(args, device, mesh=None):
    """Select and run the command line's worker; on a mesh (--distributed)
    a worker that spreads takes it, any other runs on rank 0 alone."""
    module = _worker_module(args.project, args.worker)
    spreads = getattr(getattr(module, WORKER_CLASS, None), "uses_mesh",
                      False)
    if mesh is not None and not spreads and mesh.rank != 0:
        return 0
    worker = select_worker(args.project, args.worker, args.settings,
                           device=device,
                           **({"mesh": mesh} if mesh and spreads else {}))
    if args.experiment:
        from xframe_tpu_torch import comm
        # the worker settings' `experiment` block overrides the
        # experiment's settings tree
        ekw = dict(worker.settings.get("experiment", {}) or {})
        ekw.pop("name", None)
        comm.select_experiment(args.experiment, args.experiment_settings,
                               **ekw)
    worker.run()
    return 0
