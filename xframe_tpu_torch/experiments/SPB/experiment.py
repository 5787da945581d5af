"""SPB experiment: calibrated AGIPD frames streamed from a EuXFEL run
folder.

A copy of `xframe_tpu.experiments.SPB.experiment` (host numpy and h5py,
on the port's `detectors/agipd.py`; tests/test_torch_spb.py holds its
chunks bitwise to the JAX worker's). A run folder holds one or more
sequence files per module (`RAW-…-AGIPD{mod:02}-S{seq:05}.h5`) with
datasets under `INSTRUMENT/…/image/{data,trainId,cellId,pulseId}`. A host
FrameIndex addresses the frames of all sequence files globally, so that a
read spans file boundaries, and the correlator takes whole calibrated
batches.

Bad frames: trainId 0, a trainId outside the run's range (bit flips),
repeated trainIds beyond the pulses per train, the pulseId and cellId
sentinel 65535, and cells outside good_cells or inside bad_cells. The
calibration takes flat, per-memory-cell or adaptive three-gain-stage
constants.

h5py is imported inside the functions that read files: the module imports
without it, and building an ExperimentWorker where h5py is not installed
raises an ImportError that names it.
"""
from __future__ import annotations

import glob
import logging
import os
from dataclasses import dataclass

import numpy as np

from xframe_tpu_torch.experiments.SPB.detectors.agipd import AGIPD
from xframe_tpu_torch.interfaces import ExperimentWorkerInterface
from xframe_tpu_torch.io.hdf5 import require

log = logging.getLogger("xframe_tpu_torch")

BAD_ID = 65535  # EuXFEL sentinel for missing pulse/cell ids (uint16 max)


def _filter_sequence_from_settings(sequence, filters):
    """Declarative filter pipeline from settings (the filter_sequence and
    filters blocks of experiments/SPB/settings/default_0.01.json): each
    name in `sequence` looks up `filters[name]`, whose `class` key names an
    exp_library filter; the remaining keys are its constructor kwargs."""
    from xframe_tpu_torch.experiments.SPB import exp_library as xl
    if not sequence:
        return None
    insts = []
    for name in sequence:
        spec = filters.get(name)
        if spec is None:
            raise KeyError(f"filter_sequence entry {name!r} has no "
                           f"filters.{name} block")
        spec = dict(spec)
        cls_name = spec.pop("class")
        cls = getattr(xl, cls_name, None)
        if cls is None:
            raise KeyError(f"unknown filter class {cls_name!r} "
                           f"(see experiments.SPB.exp_library)")
        insts.append(cls(**spec))
    return xl.FilterSequence(insts)


@dataclass
class DataSelection:
    """Which frames to stream."""
    frame_range: tuple = (0, None)          # (start, stop) over the run
    modules: tuple = tuple(range(16))
    batch_size: int = 32
    good_cells_only: bool = True            # drop frames failing the id rules
    cells: tuple | None = None              # explicit cellId selection
    trains: tuple | None = None             # explicit trainId selection
    train_range: tuple | None = None        # [lo, hi) trainId window


@dataclass
class Filters:
    mask_below: float | None = None
    mask_above: float | None = None
    lit_pixel_fraction_min: float = 0.0


@dataclass
class FrameIndex:
    """Global frame addressing over per-module sequence-file lists plus the
    train/pulse/cell bookkeeping of the run."""
    n_frames: int
    file_counts: dict            # module -> np.ndarray of per-file frame counts
    file_starts: dict            # module -> cumulative start offsets (len+1)
    train_ids: np.ndarray        # (n_frames,) uint64
    pulse_ids: np.ndarray        # (n_frames,) uint64
    cell_ids: np.ndarray         # (n_frames,) uint16
    frame_mask: np.ndarray       # (n_frames,) bool — good frames
    n_pulses: int = 0


class ExperimentWorker(ExperimentWorkerInterface):
    """Streams calibrated AGIPD frames from a run folder."""

    def __init__(self, run_folder, geometry_file=None, detector_distance=0.217,
                 wavelength=1.23984, data_path_glob="*AGIPD{module:02d}*.h5",
                 image_key="image/data", calibration=None,
                 filters: Filters | None = None, good_cells=None,
                 bad_cells=None, filter_sequence=None):
        require()
        self.run_folder = run_folder
        self.wavelength = float(wavelength)
        self.detector = AGIPD(geometry_file=geometry_file,
                              detector_distance=detector_distance)
        self.data_path_glob = data_path_glob
        self.image_key = image_key
        self.calibration = calibration
        self.filters = filters or Filters()
        # exp_library.FilterSequence: composable pixel/frame filters applied
        # per chunk
        self.filter_sequence = filter_sequence
        self.good_cells = None if good_cells is None \
            else np.asarray(good_cells)
        self.bad_cells = None if bad_cells is None else np.asarray(bad_cells)
        self._module_files = self._discover_files()
        self._key_cache = {}
        self.index = self._build_index()

    @classmethod
    def from_settings(cls, opt, **overrides):
        """Build the worker from an experiment's merged settings
        (settings.load_experiment_settings; the CLI's `-eset`). Explicit
        keyword overrides win over settings values."""
        opt = dict(opt)
        kwargs = {}
        for key in ("run_folder", "geometry_file", "detector_distance",
                    "wavelength", "data_path_glob", "image_key",
                    "calibration", "good_cells", "bad_cells"):
            if opt.get(key) is not None:
                kwargs[key] = opt[key]
        energy = opt.get("x_ray_energy")
        if energy and "wavelength" not in overrides:
            from xframe_tpu_torch.library.physics import \
                energy_to_wavelength
            kwargs["wavelength"] = energy_to_wavelength(float(energy))
        if opt.get("filters") or opt.get("filter_sequence"):
            seq = _filter_sequence_from_settings(
                opt.get("filter_sequence") or [], opt.get("filters") or {})
            if seq is not None:
                kwargs["filter_sequence"] = seq
        kwargs.update(overrides)
        if kwargs.get("run_folder") is None:
            raise ValueError("SPB: no run_folder; set it in the experiment "
                             "settings or in the worker settings' "
                             "experiment block")
        return cls(**kwargs)

    # ----------------------------------------------------------------- files
    def _discover_files(self):
        files = {}
        for mod in range(16):
            pattern = os.path.join(self.run_folder,
                                   self.data_path_glob.format(module=mod))
            found = sorted(glob.glob(pattern))
            if found:
                files[mod] = found
        if not files:
            raise FileNotFoundError(
                f"no module files matching {self.data_path_glob!r} under "
                f"{self.run_folder}")
        return files

    def _find_dataset(self, h5file, key):
        """Locate `…/image/data`-style keys. Deterministic: collects ALL
        matches; with several, a unique INSTRUMENT/-rooted one
        wins, otherwise the ambiguity is an error listing the candidates —
        never a silent first-visititems-hit choice."""
        cache_key = (h5file.filename, key)
        if cache_key in self._key_cache:
            return self._key_cache[cache_key]
        hits = []

        def visit(name, obj):
            h5py = require()
            if isinstance(obj, h5py.Dataset) and name.endswith(key):
                hits.append(name)

        h5file.visititems(visit)
        if not hits:
            raise KeyError(f"no dataset ending in {key!r} in {h5file.filename}")
        if len(hits) > 1:
            instrument = [h for h in hits if h.startswith("INSTRUMENT/")]
            if len(instrument) == 1:
                hits = instrument
            else:
                raise ValueError(
                    f"ambiguous dataset key {key!r} in {h5file.filename}: "
                    f"{sorted(hits)} — pass an unambiguous image_key "
                    f"(e.g. the full INSTRUMENT/... path)")
        self._key_cache[cache_key] = hits[0]
        return hits[0]

    def _id_key(self, name):
        """image/data -> image/trainId etc. (same group as the image data)."""
        base = self.image_key.rsplit("/", 1)[0]
        return f"{base}/{name}"

    def _read_ids(self, f, name, n):
        """Read an id dataset if present; raw data stores ids with an extra
        trailing dim, which is raveled."""
        try:
            path = self._find_dataset(f, self._id_key(name))
        except KeyError:
            return None
        ids = np.asarray(f[path]).ravel()
        if len(ids) != n:
            return None
        return ids

    # ----------------------------------------------------------------- index
    def _build_index(self) -> FrameIndex:
        """Scan all sequence files once: per-module frame counts (must agree
        across modules), global
        train/pulse/cell ids from the lowest module, bad-frame mask."""
        h5py = require()
        file_counts, file_starts = {}, {}
        ref_mod = min(self._module_files)
        trains, pulses, cells = [], [], []
        for mod, paths in self._module_files.items():
            counts = []
            for path in paths:
                with h5py.File(path, "r") as f:
                    dset = f[self._find_dataset(f, self.image_key)]
                    n = dset.shape[0]
                    counts.append(n)
                    if mod == ref_mod:
                        t = self._read_ids(f, "trainId", n)
                        p = self._read_ids(f, "pulseId", n)
                        c = self._read_ids(f, "cellId", n)
                        trains.append(t if t is not None
                                      else np.zeros(n, dtype=np.uint64))
                        pulses.append(p if p is not None
                                      else np.zeros(n, dtype=np.uint64))
                        cells.append(c if c is not None
                                     else np.zeros(n, dtype=np.uint16))
            file_counts[mod] = np.asarray(counts, dtype=int)
            file_starts[mod] = np.concatenate([[0], np.cumsum(counts)])
        totals = {m: int(c.sum()) for m, c in file_counts.items()}
        if len(set(totals.values())) > 1:
            raise ValueError(
                f"modules disagree on total frame count: {totals} — "
                f"incomplete run folder")
        n_frames = totals[ref_mod]
        train_ids = np.concatenate(trains) if trains else \
            np.zeros(n_frames, dtype=np.uint64)
        pulse_ids = np.concatenate(pulses) if pulses else \
            np.zeros(n_frames, dtype=np.uint64)
        cell_ids = np.concatenate(cells) if cells else \
            np.zeros(n_frames, dtype=np.uint16)
        mask, n_pulses = self._frame_mask(train_ids, pulse_ids, cell_ids)
        return FrameIndex(n_frames=n_frames, file_counts=file_counts,
                          file_starts=file_starts, train_ids=train_ids,
                          pulse_ids=pulse_ids, cell_ids=cell_ids,
                          frame_mask=mask, n_pulses=n_pulses)

    def _frame_mask(self, train_ids, pulse_ids, cell_ids):
        """The bad-frame rules (see the module docstring).

        Every rule's marginal drop count is recorded in self.drop_counts and
        logged, so that a run shows what was excluded and why."""
        has_ids = bool(train_ids.any())
        mask = np.ones(len(train_ids), dtype=bool)
        n_pulses = 0
        drops = {}

        def apply(rule, keep):
            nonlocal mask
            drops[rule] = int((mask & ~keep).sum())
            mask = mask & keep

        if has_ids:
            positive = train_ids > 0
            apply("trainId_zero", positive)
            if positive.any():
                # pulses per train = median multiplicity of unique pulse ids
                _, counts = np.unique(pulse_ids[positive], return_counts=True)
                n_trains = int(np.median(counts))
                _, pcounts = np.unique(train_ids[positive], return_counts=True)
                n_pulses = int(np.median(pcounts))
                first = int(train_ids[positive].min())
                last = first + n_trains - 1
                apply("trainId_out_of_range",
                      (train_ids >= first) & (train_ids <= last))
                # repeated trainIds: keep only the first n_pulses occurrences
                uniq, counts = np.unique(train_ids, return_counts=True)
                if (counts > n_pulses).any():
                    occurrence = np.zeros(len(train_ids), dtype=int)
                    for u in uniq[counts > n_pulses]:
                        idx = np.nonzero(train_ids == u)[0]
                        occurrence[idx] = np.arange(len(idx))
                    apply("trainId_repeats", occurrence < n_pulses)
        apply("pulseId_sentinel", pulse_ids != np.uint64(BAD_ID))
        apply("cellId_sentinel", cell_ids != np.uint16(BAD_ID))
        if self.good_cells is not None:
            apply("good_cells", np.isin(cell_ids, self.good_cells))
        if self.bad_cells is not None:
            apply("bad_cells", ~np.isin(cell_ids, self.bad_cells))
        self.drop_counts = drops
        n_dropped = int((~mask).sum())
        if n_dropped:
            detail = ", ".join(f"{k}: {v}" for k, v in drops.items() if v)
            log.info("SPB frame index: dropped %d of %d frames (%s)",
                     n_dropped, len(mask), detail)
        return mask, n_pulses

    def n_frames(self):
        return self.index.n_frames

    # --------------------------------------------------------------- reading
    def _read_range(self, mod, handles, lo, hi):
        """Read global frames [lo, hi) of a module across sequence files."""
        starts = self.index.file_starts[mod]
        pieces = []
        f0 = int(np.searchsorted(starts, lo, side="right")) - 1
        pos = lo
        for fi in range(f0, len(starts) - 1):
            if pos >= hi:
                break
            a = pos - starts[fi]
            b = min(hi, starts[fi + 1]) - starts[fi]
            if b <= a:
                continue
            pieces.append(np.asarray(handles[mod][fi][a:b], dtype=np.float32))
            pos = starts[fi] + b
        if len(pieces) == 1:
            return pieces[0]
        return np.concatenate(pieces, axis=0)

    def get_data(self, selection: DataSelection | None = None):
        """Generator of dicts {'data': (B, n_mod, ss, fs) float32,
        'frame_ids', 'train_ids', 'pulse_ids', 'cell_ids': (B,),
        'good': (B,) bool}."""
        h5py = require()
        sel = selection or DataSelection()
        total = self.n_frames()
        start, stop = sel.frame_range
        stop = total if stop is None else min(stop, total)
        mods = list(sel.modules)
        idx = self.index

        files, handles = [], {}
        try:
            for mod in mods:
                handles[mod] = []
                for path in self._module_files[mod]:
                    f = h5py.File(path, "r")
                    files.append(f)
                    handles[mod].append(f[self._find_dataset(f, self.image_key)])
            for lo in range(start, stop, sel.batch_size):
                hi = min(lo + sel.batch_size, stop)
                batch = np.stack([self._read_range(mod, handles, lo, hi)
                                  for mod in mods], axis=1)
                cells = idx.cell_ids[lo:hi]
                batch, cal_good = self._calibrate(batch, mods, cells)
                good = self._good_mask(batch) & cal_good
                if sel.good_cells_only:
                    good = good & idx.frame_mask[lo:hi]
                if sel.cells is not None:
                    good = good & np.isin(cells, np.asarray(sel.cells))
                if sel.trains is not None:
                    good = good & np.isin(
                        idx.train_ids[lo:hi],
                        np.asarray(sel.trains, dtype=np.uint64))
                if sel.train_range is not None:
                    t = idx.train_ids[lo:hi]
                    good = good & (t >= np.uint64(sel.train_range[0])) \
                        & (t < np.uint64(sel.train_range[1]))
                chunk = {"data": batch,
                         "mask": np.ones(batch.shape, dtype=bool),
                         "good": good,
                         "frame_ids": np.arange(lo, hi),
                         "train_ids": idx.train_ids[lo:hi],
                         "pulse_ids": idx.pulse_ids[lo:hi],
                         "cell_ids": cells}
                if self.filter_sequence is not None:
                    chunk = self.filter_sequence(chunk)
                yield chunk
        finally:
            for f in files:
                f.close()

    # ----------------------------------------------------------- calibration
    def _calibrate(self, batch, mods, cells):
        """Dispatch: flat / per-memory-cell / adaptive 3-gain-stage constants.
        Returns (calibrated batch, per-frame good mask)."""
        good = np.ones(len(batch), dtype=bool)
        if not self.calibration:
            return batch, good
        cal = self.calibration
        if "analog_offset" in cal:
            return self._calibrate_adaptive(batch, mods, cells)
        cells = np.asarray(cells, dtype=int)
        # frames with the 65535 cellId sentinel reach here (contiguous-range
        # reads precede the bad-frame mask): clamp their index to 0 for the
        # per-cell lookups and flag them bad instead of IndexError-ing
        ok = cells != BAD_ID
        cells = np.where(ok, cells, 0)
        off = cal.get("offset")
        gain = cal.get("gain")
        if (off is not None and np.asarray(off).ndim == 4) \
                or (gain is not None and np.asarray(gain).ndim == 4):
            good = good & ok
        if off is not None:
            off = np.asarray(off, dtype=np.float32)
            if off.ndim == 4:   # per-cell (16, n_cells, ss, fs)
                batch = batch - np.swapaxes(off[mods][:, cells], 0, 1)
            else:               # flat (16, ss, fs)
                batch = batch - off[None][:, mods]
        if gain is not None:
            gain = np.asarray(gain, dtype=np.float32)
            if gain.ndim == 4:
                batch = batch * np.swapaxes(gain[mods][:, cells], 0, 1)
            else:
                batch = batch * gain[None][:, mods]
        return batch, good

    def _calibrate_adaptive(self, batch, mods, cells):
        """Adaptive-gain AGIPD calibration: raw frames carry (analog, digital) planes;
        per pixel the gain stage ∈ {high, medium, low} is chosen by
        thresholding the digital signal against DigitalGainLevel, then
        data = (analog − AnalogOffset[stage, cell, mod]) × RelativeGain[...].
        Constants are indexed [stage(3), cell, module, ss, fs]."""
        cal = self.calibration
        cells = np.asarray(cells, dtype=int)
        # sentinel cellIds: clamp the constant lookups, flag the frame bad
        # (`good` below) — the raw index 65535 would IndexError
        ok = cells != BAD_ID
        cells = np.where(ok, cells, 0)
        if batch.ndim != 5 or batch.shape[2] != 2:
            raise ValueError(
                "adaptive calibration expects raw batches shaped "
                f"(B, n_mod, 2, ss, fs), got {batch.shape}")
        analog = batch[:, :, 0]
        digital = batch[:, :, 1]

        def sel(name):
            # (3, n_cells, 16, ss, fs) -> (3, B, M, ss, fs)
            c = np.asarray(cal[name], dtype=np.float32)
            return c[:, cells][:, :, mods]

        thr = sel("gain_levels")
        low = digital > thr[2]
        high = digital < thr[1]
        stage = np.where(low, 2, np.where(high, 0, 1))  # (B, M, ss, fs)
        take = lambda c: np.take_along_axis(c, stage[None], axis=0)[0]  # noqa: E731
        data = (analog - take(sel("analog_offset"))) \
            * take(sel("relative_gain"))
        if "badpixel" in cal:
            bad = take(sel("badpixel")) != 0
            data = np.where(bad, 0.0, data)
        thresh = cal.get("photon_threshold")
        if thresh is not None:
            # 1 photon = 45 ADU
            g = take(sel("relative_gain"))
            if isinstance(thresh, (list, tuple)):
                below = (data < thresh[0] * 45 * g) | (data > thresh[1] * 45 * g)
            else:
                below = data < float(thresh) * 45 * g
            data = np.where(below, 0.0, data)
        return data.astype(np.float32), ok

    def _good_mask(self, batch):
        flt = self.filters
        good = np.ones(len(batch), dtype=bool)
        if flt.lit_pixel_fraction_min > 0:
            frac = (batch > 0).mean(axis=tuple(range(1, batch.ndim)))
            good &= frac >= flt.lit_pixel_fraction_min
        return good

    # -------------------------------------------------------------- geometry
    def get_geometry(self):
        return self.detector.pixel_centers

    def get_pixel_grid_reciprocal(self):
        return self.detector.pixel_grid_reciprocal(self.wavelength)

    def run(self):  # experiments are passive data providers here
        return None
