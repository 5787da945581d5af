"""The contract between the command line and a project's workers.

The counterpart of `xframe_tpu.interfaces`: a worker is built from its
merged settings (plain nested dicts, xframe_tpu_torch.settings) and a
device, and exposes `run()`. User projects under <home>/projects/<name>/
subclass ProjectWorkerInterface as `ProjectWorker`. An experiment
(`experiments/<name>/experiment.py`, bound through `comm`) serves detector
data and geometry to the projects.
"""
from __future__ import annotations

import abc


class ProjectWorkerInterface(abc.ABC):
    """One runnable step of a project. The device is resolved as the fxs
    workers resolve theirs: a CUDA device where none exists raises."""

    def __init__(self, settings: dict, device="cuda"):
        from xframe_tpu_torch.projects.fxs.reconstruct import device_of
        self.settings = settings
        self.device = device_of(device)

    @abc.abstractmethod
    def run(self):
        ...


class ExperimentWorkerInterface(abc.ABC):
    """Facility data access: frames, pixel geometry, reciprocal grid."""

    @abc.abstractmethod
    def get_data(self, selection):
        ...

    @abc.abstractmethod
    def get_geometry(self):
        ...

    @abc.abstractmethod
    def get_pixel_grid_reciprocal(self):
        ...
