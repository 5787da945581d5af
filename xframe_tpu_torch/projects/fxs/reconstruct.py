"""The reconstruct worker: multi-start MTIP phasing from extracted
invariants.

Port of `xframe_tpu.projects.fxs.reconstruct`, 3D and 2D (polar: the
stepwise MTIP on circular harmonics with rank-1 data vectors, an optional
SO(2) gauge pin and the output's orientation fix). The worker reads an
invariants archive (projects/fxs/store.py), builds the port's transforms,
constraints and MTIP from its settings (plain nested dicts, see
xframe_tpu_torch.settings), runs the restarts through the runners of
parallel/mesh.py in chunks of multi_start.batch_size, ranks them and
writes the results as an archive with the JAX package's layout (HDF5 where
h5py imports, else `.npz`; store.py).
The restarts of a chunk are the batch axis of one MTIP run. With more
than one device (every visible card for a bare "cuda", or the `devices`
given) the `mesh` settings spread them as the JAX package's `_make_mesh`
does: `mesh.restarts` ("all" or a count) ranks, clamped to the devices and
to a chunk's restarts, one process each (parallel/mesh.py); each rank
sets up the worker on its device and runs its rows of each chunk, and rank
0 collects, ranks and alone writes the archive, the checkpoint and the
Hankel cache. Under `--distributed` the ranks that torchrun started are
the mesh. `mesh.theta` > 1 is flattened into restarts on the fused path
and in 2D, as the JAX package does there; on the 3D plain path (precision
float64 or fused_sht false) it shards θ as the JAX package does: the mesh
{"restarts": n_r, "theta": T}, each rank setting up whole and running
the MTIP's θ shard on its θ rows, the analyses and the grid's reductions
summed over the T ranks of its restart group; rank 0 collects and saves
on the whole grid, the one-card archive.

Host helpers are numpy copies of the JAX module's: `load_cached_weights`
(the Hankel weights cache under <home>/cache), `_interp_radial`,
`regrid_projection_matrices`, `pad_coeff_dense`, `_resolve_ns_schedule`,
`_error_config`, `_particle_number`, `_radial_mask`, `_build_schedule`,
`so2_residual_rotation_phase` and `rotate_polar_density`.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from xframe_tpu_torch.library.shapes import (get_test_function, polar_grid,
                                             spherical_grid,
                                             spherical_to_cartesian)
from xframe_tpu_torch.ops import _build
from xframe_tpu_torch.ops.fourier import (PolarFourierTransform,
                                          SphericalFourierTransform)
from xframe_tpu_torch.ops.hankel import generate_weights
from xframe_tpu_torch.ops.integrate import PolarIntegrator, SphericalIntegrator
from xframe_tpu_torch.ops.polar_schedule import default_or_computed_schedule
from xframe_tpu_torch.parallel.mesh import (CheckpointingRunner,
                                            MultiStartRunner, make_mesh,
                                            rank_restarts, run_ranks,
                                            visible_devices)
from xframe_tpu_torch.projects.fxs import invariants as itools
from xframe_tpu_torch.projects.fxs.phasing import (MTIP, PhasingState,
                                                   build_schedule,
                                                   bump_density_guess)
from xframe_tpu_torch.projects.fxs.projections import (
    RealCircularHarmonics, ReciprocalConstraint, ReciprocalConstraintPolar,
    RealConstraint, ShrinkWrap,
)
from xframe_tpu_torch.io import hdf5
from xframe_tpu_torch.projects.fxs.store import (ProjectStore, archive_ext,
                                                 load_archive, save_archive)
from xframe_tpu_torch.settings import home_dir
from xframe_tpu_torch.tracing import span


def device_of(device):
    """torch.device(device); a CUDA device where none exists raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: CUDA is not available")
    return device


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_cached_weights(l_max, n_radial_points, reciprocity_coefficient,
                        dimensions, mode, allow_cache=True,
                        allow_calculation=True, allow_saving=None):
    """Hankel weight tables with a disk cache under <home>/cache keyed by
    (dimensions, mode, N, L, reciprocity coefficient): the JAX package's
    `hankel_….h5` (weights_real, weights_imag, posHarmOrders) where h5py
    imports, else an `.npz` of the same stem and layout; either is read.
    allow_calculation and allow_saving are the
    fourier_transform.allow_weight_* switches; allow_cache gates the load
    (and is the saving default)."""
    stem = os.path.join(
        home_dir(), "cache",
        f"hankel_{dimensions}d_{mode}_N{n_radial_points}_L{l_max}"
        f"_rc{reciprocity_coefficient:.6g}")
    found = [p for p in ((stem + ".h5",) if hdf5.available() else ())
             + (stem + ".npz",) if os.path.exists(p)]
    if allow_cache and found:
        data = load_archive(found[0])
        weights = np.asarray(data["weights"]) if "weights" in data else \
            np.asarray(data["weights_real"]) \
            + 1j * np.asarray(data["weights_imag"])
        return {"weights": weights,
                "posHarmOrders": np.asarray(data["posHarmOrders"]),
                "mode": mode, "dimension": dimensions}
    if not allow_calculation:
        raise FileNotFoundError(
            f"Hankel weights not cached at {stem}.h5 or .npz and "
            "fourier_transform.allow_weight_calculation is False")
    wd = generate_weights(l_max, n_radial_points, reciprocity_coefficient,
                          dimensions, mode)
    if allow_cache if allow_saving is None else allow_saving:
        save_archive(stem + ".h5", {
            "weights_real": np.real(wd["weights"]),
            "weights_imag": np.imag(wd["weights"]),
            "posHarmOrders": wd["posHarmOrders"]})
    return wd


def _interp_radial(y, qs_data, qs_new, interpolation="linear"):
    """Interpolate (n_q_data, ...) data onto qs_new along axis 0:
    'nearest' | 'linear' | 'cubic', 0 outside the data range."""
    y = np.asarray(y)
    qs_data = np.asarray(qs_data, dtype=float)
    qs_new = np.asarray(qs_new, dtype=float)
    if y.shape[0] != len(qs_data):
        raise ValueError("radial axis mismatch")
    if len(qs_data) == len(qs_new) and np.array_equal(qs_data, qs_new):
        return y.copy()
    inside = (qs_new >= qs_data[0]) & (qs_new <= qs_data[-1])
    if interpolation == "nearest":
        idx = np.abs(qs_new[:, None] - qs_data[None, :]).argmin(axis=1)
        out = y[idx].astype(y.dtype if np.iscomplexobj(y) else float)
    elif interpolation == "cubic" and len(qs_data) >= 4:
        from scipy.interpolate import CubicSpline
        out = CubicSpline(qs_data, y, axis=0)(np.clip(
            qs_new, qs_data[0], qs_data[-1]))
    else:
        flat = y.reshape(len(qs_data), -1)
        cols = [np.interp(qs_new, qs_data, flat[:, j].real)
                + (1j * np.interp(qs_new, qs_data, flat[:, j].imag)
                   if np.iscomplexobj(y) else 0.0)
                for j in range(flat.shape[1])]
        out = np.stack(cols, axis=1).reshape((len(qs_new),) + y.shape[1:])
    out[~inside] = 0.0
    return out


def regrid_projection_matrices(proj, qs_data, qs_new, interpolation="linear"):
    """Each V_l's columns from the data q-grid onto the internal grid."""
    out = []
    for v in proj:
        v = np.atleast_2d(np.asarray(v))
        if v.shape[0] == 1 and v.shape[1] != len(qs_data):
            v = v.T
        out.append(_interp_radial(v.astype(complex), qs_data, qs_new,
                                  interpolation))
    return out


def pad_coeff_dense(proj_list, n_q, l_max):
    """Per-l (n_q, k ≤ 2l+1) matrices → the dense (n_q, 2L+1, L+1)
    coefficient tensor in the centered-m layout, missing columns zero."""
    L = l_max
    dense = np.zeros((n_q, 2 * L + 1, L + 1), dtype=complex)
    for l, v in enumerate(proj_list[: L + 1]):
        v = np.atleast_2d(np.asarray(v))
        if v.shape[0] != n_q:
            v = v.T
        ncols = min(v.shape[1], 2 * l + 1)
        dense[:, L - l: L - l + ncols, l] = v[:, :ncols]
    return dense


def so2_residual_rotation_phase(unknowns, proj, qs, radial_high_pass=0.2):
    """The residual in-plane rotation of a 2D output: the SO(2) gauge pin
    leaves an m1-fold discrete rotation ambiguity (m1 the strongest even
    order), which the next ranked orders reduce through gcd chains.
    → the angle phi0 of the coefficient rotation c_m·e^{i m phi0}."""
    unknowns = np.asarray(unknowns).reshape(-1)
    M = len(unknowns) - 1
    orders = np.arange(M + 1)
    qs = np.asarray(qs, dtype=float)
    lo = int((len(qs) - 1) * float(radial_high_pass))
    strength = np.array([np.abs(np.asarray(proj[m]).reshape(-1)[lo:]).sum()
                         if m < len(proj) else 0.0 for m in orders])
    emask = (orders % 2 == 0) & (orders > 0)
    h_orders = orders[emask]
    if len(h_orders) == 0:
        return 0.0
    ranked = np.argsort(-strength[emask])
    phases = np.angle(unknowns[emask])
    current = int(h_orders[ranked[0]])
    remaining = current
    free = np.ones(len(ranked), dtype=bool)
    rotation_phase = 0.0
    while remaining > 2:
        multiples = np.arange(current, h_orders.max() + 1, current)
        mult_idx = np.where(np.isin(h_orders, multiples))[0]
        free &= ~np.isin(ranked, mult_idx)
        if not free.any():
            break
        cur_idx = int(ranked[free][0])
        current = int(h_orders[cur_idx])
        g = int(np.gcd(remaining, current))
        n_ind = remaining // g
        if n_ind <= 1:
            continue  # the order is invariant under the remaining rotations
        angle = 2 * np.pi / n_ind
        coeff = int(np.argmin((np.arange(1, n_ind) * (current // g))
                              % n_ind)) + 1
        rotation_phase -= (phases[cur_idx] // angle) * coeff * angle / g
        remaining = g
    return float(rotation_phase)


def rotate_polar_density(arr, phi0):
    """Rotate a (..., n_q, n_φ) polar field in-plane by phi0 through its
    circular harmonics, c_m·e^{i m phi0} (host numpy, complex)."""
    arr = np.asarray(arr)
    n_phi = arr.shape[-1]
    m = np.fft.fftfreq(n_phi, d=1.0 / n_phi).round().astype(int)
    c = np.fft.fft(arr, axis=-1) * np.exp(1j * m * phi0)
    out_dtype = arr.dtype if np.iscomplexobj(arr) else np.complex128
    return np.fft.ifft(c, axis=-1).astype(out_dtype)


def _resolve_ns_schedule(ropt):
    """fxs_unknowns.ns_coefficients → the per-step quintic coefficients of
    the Newton–Schulz polar (None: the fixed 16 + 4 iteration).
    'minimax' takes the baked schedule for ns_sigma_min = 1e-7 and the
    linear programs' schedule for any other bound."""
    mode = str(ropt.get("ns_coefficients", "minimax"))
    if mode == "fixed":
        return None
    if mode != "minimax":
        raise ValueError(f"unknown ns_coefficients mode {mode!r} "
                         "(expected 'minimax' or 'fixed')")
    return default_or_computed_schedule(float(ropt.get("ns_sigma_min", 1e-7)))


def _error_config(opt):
    """main_loop.error.methods → MTIP's error_config."""
    eopt = opt["main_loop"].get("error", {})
    methods = eopt.get("methods", {})
    real = methods.get("real", {})
    rec = methods.get("reciprocal", {})
    main = methods.get("main", {})
    cfg = {
        "real": list(real.get("calculate", ["l2_projection_diff"])),
        "reciprocal": list(rec.get("calculate", [])),
        "real_inside_initial_support": bool(
            real.get("l2_projection_diff", {})
            .get("inside_initial_support", True)),
        "deg2_order": int(rec.get("deg2_invariant_l2_diff", {})
                          .get("order", 2)),
    }
    if main:
        mm = main.get("metrics", {})
        cfg["main"] = {
            "metrics": {
                "real": list(mm.get("real", ["l2_projection_diff"])),
                "reciprocal": list(mm.get("reciprocal", []))},
            "type": str(main.get("type", "mean"))}
    return cfg


def _particle_number(ropt, inv):
    """projections.reciprocal.number_of_particles → (initial N, the
    estimate's scan space (lo, hi, K) or None, project, estimate_in: the
    methods that estimate, None for all). 'initial: from_data' takes the
    invariants' estimate; 'estimate' is a dict or the reference's bool with
    a sibling 'settings'."""
    pn_opt = ropt.get("number_of_particles", {})
    n0 = pn_opt.get("initial", 1)
    if isinstance(n0, str) and n0 == "from_data":
        n0 = float(inv.get("number_of_particles", 1) or 1)
    est = pn_opt.get("estimate", {})
    if isinstance(est, bool):
        est = {"apply": est, **dict(pn_opt.get("settings", {}))}
    apply = bool(est.get("apply", False))
    scan = tuple(est.get("scan_space", [1.0, 10.0, 64])) if apply else None
    est_in = est.get("estimate_in", "all")
    est_in = None if (isinstance(est_in, str) and est_in == "all") \
        else tuple(str(m) for m in est_in)
    return float(n0), scan, bool(est.get("project", False)), est_in


def _radial_mask(ropt, L, qs, qs_data=None, q_id_limits=None):
    """The reciprocal projection's radial mask (L+1, n_q), or None where it
    keeps everything: q_mask type 'none', 'manual' ('region' or
    'order_dependent_line') or 'from_projection_matrices' (the data's
    per-order q-id limits), each intersected with the data q-range."""
    qm = ropt.get("q_mask", {})
    mtype = str(qm.get("type", "none"))
    qs = np.asarray(qs, dtype=float)
    mask = np.ones((L + 1, len(qs)), dtype=bool)
    if mtype in ("from_projection_matrices", "from_invariants"):
        if q_id_limits is not None and qs_data is not None:
            lims = np.asarray(q_id_limits, dtype=int).reshape(-1, 2)
            qs_data = np.asarray(qs_data, dtype=float)
            for l in range(min(L + 1, len(lims))):
                lo_id, hi_id = lims[l]
                if hi_id <= lo_id:
                    mask[l] = False
                    continue
                mask[l] = (qs > qs_data[lo_id]) & (qs < qs_data[hi_id - 1])
    elif mtype == "manual":
        man = qm.get("manual", None)
        if isinstance(man, dict):
            sub = str(man.get("type", "region"))
        else:
            man = qm  # flat schema: region directly under q_mask
            sub = "region"
        if sub == "region":
            lo, hi = man.get("region", [False, False])
            if lo is not False and lo is not None:
                mask &= (qs >= float(lo))[None, :]
            if hi is not False and hi is not None:
                mask &= (qs < float(hi))[None, :]
        elif sub == "order_dependent_line":
            pts = np.asarray(man.get("order_dependent_line",
                                     [[4, 0.004], [70, 0.3]]), dtype=float)
            # keep the (order, q) half-plane on the non-positive side of the
            # line p1 → p2 (signed distance along its normal)
            p1, p2 = pts
            d = p2 - p1
            rot = np.array([d[1], -d[0]])
            ls = np.arange(L + 1, dtype=float)
            dist = ((ls[:, None] - p1[0]) * rot[0]
                    + (qs[None, :] - p1[1]) * rot[1])
            mask = (-dist) >= 0
    if qs_data is not None and len(qs_data):
        qs_data = np.asarray(qs_data, dtype=float)
        mask &= ((qs >= qs_data.min()) & (qs <= qs_data.max()))[None, :]
    if mask.all():
        return None
    return mask


def _build_schedule(opt, ft):
    """The flattened schedule of main_loop.sub_loops, σ defaulting to the
    radial grid spacing."""
    real = opt["projections"]["real"]
    return build_schedule(opt["main_loop"]["sub_loops"], real["HIO"]["beta"],
                          real["shrink_wrap"]["sigmas"],
                          real["shrink_wrap"]["thresholds"],
                          opt["main_loop"].get("ft_stabilization", {}),
                          default_sigma=float(ft.rs[1] - ft.rs[0]))


def _fused_sht(opt):
    """fourier_transform.fused_sht: 'auto' and True run the SHT kernels
    (the plain transforms on CPU tensors) and the fused iteration; False
    the plain transforms and the stepwise iteration, on either device."""
    cfg = opt["fourier_transform"].get("fused_sht", "auto")
    return True if (isinstance(cfg, str) and cfg == "auto") else bool(cfg)


# the JAX package's warning where precision float64 turns its kernels off
FLOAT64_WARNING = ("precision float64 requested: disabling the fused f32 "
                   "SHT kernels (set fourier_transform.fused_sht: true AND "
                   "precision: float32 for the fast path)")


def _real_dtype(opt):
    """torch.float64 under precision: float64, else torch.float32."""
    return torch.float64 if str(opt.get("precision", "float32")) \
        == "float64" else torch.float32


def mesh_devices(device, devices=None):
    """The devices a worker may spread over: `devices` where given (a
    device may repeat), every visible card for a bare "cuda", else the
    worker's one device."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device.type == "cuda" and device.index is None:
        return visible_devices()
    return [device]


def _theta_shards(opt, dim):
    """mesh.theta, and whether the worker shards θ with it: on the 3D
    plain transforms (precision float64 or fused_sht false), as the JAX
    package does; elsewhere θ is flattened into restarts.
    → (T, sharded)."""
    t = int(opt.get("mesh", {}).get("theta", 1) or 1)
    plain = not _fused_sht(opt) or _real_dtype(opt) == torch.float64
    return t, t > 1 and dim == 3 and plain


def _rank_run(mesh, settings):
    """One rank of a spawned mesh: the worker on the rank's device.
    → (results, saved, rank_launches) on rank 0."""
    w = ProjectWorker(settings, device=mesh.device, mesh=mesh)
    return w.run(), w.saved, w.rank_launches


def _cat_states(states, n):
    """One PhasingState from chunks' states, restarts concatenated and cut
    to the first n."""
    fields = {}
    for name in PhasingState._fields:
        parts = [getattr(s, name) for s in states]
        fields[name] = None if parts[0] is None \
            else torch.cat(parts, dim=0)[:n]
    return PhasingState(**fields)


class ProjectWorker:
    """reconstruct: invariants → ranked multi-start reconstructions. After
    `run` the worker keeps the archive's (path, run) (`saved`) and, where
    the restarts ran over a mesh, each rank's kernel launch counts
    (`rank_launches`, rank order)."""

    uses_mesh = True          # main.py hands it the mesh of --distributed

    def __init__(self, settings: dict, device="cuda", devices=None,
                 mesh=None):
        """devices: the devices the restarts may spread over (a device may
        repeat; default `mesh_devices`). mesh: a rank's mesh, set on the
        ranks of a mesh (parallel/mesh.py), the worker then on its
        device."""
        self.settings = settings
        self.mesh = mesh
        self.device = device_of(mesh.device if mesh is not None else device)
        self.devices = mesh_devices(self.device, devices)
        self.store = ProjectStore(settings.get("structure_name", "default"),
                                  settings)
        self.saved = self.rank_launches = None

    @property
    def _lead(self):
        """Rank 0 of the mesh, or the only process."""
        return self.mesh is None or self.mesh.rank == 0

    def _make_mesh(self, n_restarts):
        """The restarts' mesh for chunks of n_restarts, as the JAX
        package's `_make_mesh`: mesh.restarts ranks ("all": the devices
        over mesh.theta), clamped to the devices and to n_restarts, on the
        3D plain path times mesh.theta on a θ axis, {"restarts": n_r,
        "theta": T}; on the fused path and in 2D mesh.theta flattened into
        restarts, {"restarts": n_r·T}, as the JAX package's
        P(restart, None, None). None on one device."""
        if len(self.devices) <= 1:
            return None
        opt = self.settings.get("mesh", {})
        t, sharded = _theta_shards(self.settings,
                                   int(self.settings.get("dimensions", 3)))
        r = opt.get("restarts", "all")
        n_r = len(self.devices) // t if (isinstance(r, str) and r == "all") \
            else int(r)
        n_r = max(1, min(n_r, n_restarts, len(self.devices) // t))
        if n_r * t <= 1:
            return None
        return make_mesh({"restarts": n_r, "theta": t} if sharded
                         else {"restarts": n_r * t}, self.devices)

    def run(self):
        """Phase every restart and archive the results. → the results
        dict (with its "timing"); the archive's path and run number are
        kept in self.saved. Over a mesh: the ranks run it and rank 0's
        results come back; on the other ranks of a mesh, None."""
        if self.mesh is None:
            ms = self.settings["multi_start"]
            n_restarts = int(ms["n_reconstructions"])
            batch = int(ms.get("batch_size", 0) or 0)
            # a checkpointed run holds the whole batch
            chunked = 0 < batch < n_restarts and not self.settings.get(
                "checkpointing", {}).get("enable", False)
            mesh = self._make_mesh(batch if chunked else n_restarts)
            if mesh is not None:
                results, self.saved, self.rank_launches = run_ranks(
                    mesh, _rank_run, self.settings)
                return results
        return self._run()

    def _run(self):
        opt, dev, mesh = self.settings, self.device, self.mesh
        t, sharded = _theta_shards(opt, int(opt.get("dimensions", 3)))
        if mesh is not None and sharded and mesh.n_theta != t:
            # --distributed: torchrun's ranks laid out as the θ mesh
            if mesh.size % t:
                raise ValueError(f"mesh.theta = {t} does not divide the "
                                 f"{mesh.size} ranks")
            self.mesh = mesh = mesh.with_axes(
                {"restarts": mesh.size // t, "theta": t})
        build0 = _build.compile_seconds()
        with self._trace():
            t_setup0 = time.perf_counter()
            inv = self._load_invariants()
            mtip, ft, aux = self.setup_mtip(inv)
            schedule = self._build_schedule(ft)
            synchronize(dev)
            t_setup = time.perf_counter() - t_setup0

            ms = opt["multi_start"]
            n_restarts = int(ms["n_reconstructions"])
            seed = ms.get("seed")
            if seed is None or seed is False:  # seed 0 is a valid seed
                seed = int.from_bytes(os.urandom(4), "little")
            if mesh is not None:            # every rank draws rank 0's
                seed = mesh.broadcast(seed)
            seed = int(seed) & 0x7FFFFFFF
            batch = int(ms.get("batch_size", 0) or 0)
            ckpt_opt = opt.get("checkpointing", {})
            ckpt_path = None
            if ckpt_opt.get("enable", False):
                ckpt_path = os.path.join(
                    home_dir(), "data", "fxs", "checkpoints",
                    f"{opt.get('structure_name', 'default')}_phasing"
                    + archive_ext())
                if not ckpt_path.endswith(".h5") and self._lead:
                    print(f"checkpoint: {hdf5.MISSING}; writes "
                          f"{os.path.basename(ckpt_path)} in place of the "
                          "HDF5 checkpoint")
                runner = CheckpointingRunner(
                    mtip, schedule, checkpoint_path=ckpt_path,
                    save_every=int(ckpt_opt.get("save_every", 1)),
                    mesh=mesh)
            else:
                runner = MultiStartRunner(mtip, schedule, mesh=mesh)

            # restarts in sequential chunks of batch_size, chunk ci from seed
            # seed + ci; a checkpointed run holds the whole batch. Over a
            # mesh every rank draws a chunk's whole batch and runs its rows;
            # rank 0 gets the chunk's states back
            t_run0 = time.perf_counter()
            chunk_times = []
            if batch and batch < n_restarts and ckpt_path is None:
                parts = []
                for ci in range(-(-n_restarts // batch)):
                    t_c = time.perf_counter()
                    r0 = aux["initial_density_batch"](seed + ci, batch)
                    s, e = runner(r0)
                    synchronize(dev)
                    chunk_times.append(time.perf_counter() - t_c)
                    parts.append((r0, s, e))
                rho0s = torch.cat([p[0] for p in parts])[:n_restarts]
                if self._lead:
                    states = _cat_states([p[1] for p in parts], n_restarts)
                    errors = torch.cat([p[2] for p in parts])[:n_restarts]
                del parts
            else:
                rho0s = aux["initial_density_batch"](seed, n_restarts)
                states, errors = runner(rho0s)
            synchronize(dev)
            t_run = time.perf_counter() - t_run0
            self.rank_launches = runner.rank_launches
            if not self._lead:
                return None
            order, best_err = rank_restarts(states)

        t_col0 = time.perf_counter()
        results = self._collect_results(mtip, ft, aux, states, errors, order,
                                        seed, rho0s=rho0s)
        del states, errors, rho0s
        synchronize(dev)
        t_collect = time.perf_counter() - t_col0
        # phasing iterations only: SW, SW_center and the markers are not
        n_iter = sum(s.n for s in schedule
                     if s.method in ("HIO", "ER", "RAAR"))
        # nvcc's seconds inside whichever timed phase first launched a kernel
        timing = {"setup_s": t_setup, "phasing_s": t_run,
                  "collect_s": t_collect,
                  "kernel_build_s": _build.compile_seconds() - build0,
                  "sec_per_iteration_per_restart":
                      t_run / max(n_iter * n_restarts, 1)}
        if chunk_times:
            # chunk 0 carries the first calls' set-up; the rest is steady
            timing["chunk_walls_s"] = chunk_times
            steady = chunk_times[1:] or chunk_times
            timing["steady_sec_per_restart"] = \
                float(np.mean(steady)) / max(batch, 1)
        results["timing"] = timing
        t_save0 = time.perf_counter()
        self.saved = self.store.save("reconstructions", results)
        timing["save_s"] = time.perf_counter() - t_save0
        if ckpt_path and os.path.exists(ckpt_path):
            os.remove(ckpt_path)  # completed: the archive is the durable copy
        print(f"reconstruct: {n_restarts} restarts, {n_iter} iterations each "
              f"in {t_run:.1f}s, best error {best_err[order[0]]:.3e}; "
              f"saved to {self.saved[0]}")
        return results

    def _trace(self):
        """profiling.enable: a torch.profiler trace of the set-up and the
        phasing (CPU, and CUDA activity on the card) into
        profiling.trace_dir, default <home>/traces. → a context."""
        prof = self.settings.get("profiling", {})
        if not prof.get("enable", False):
            return contextlib.nullcontext()
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        trace_dir = str(prof.get("trace_dir") or "") or os.path.join(
            home_dir(), "traces")
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        # over a mesh each rank writes its own trace, named by its rank
        name = None if self.mesh is None else \
            f"rank{self.mesh.rank}_{os.getpid()}"
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(
                           trace_dir, worker_name=name))

    # ---------------------------------------------------------------- loading
    def _load_invariants(self):
        inp = self.settings.get("input", {})
        path = inp.get("invariants_path") or None
        run = inp.get("invariants_run") or None
        return self.store.load_invariants(run=int(run) if run else None,
                                          path=path)

    # ------------------------------------------------------------------ setup
    def setup_mtip(self, inv):
        """Transforms and constraints from the settings and the invariants.
        → (MTIP, ft, aux dict)."""
        dim = int(inv.get("dimensions", self.settings.get("dimensions", 3)))
        with span("xf.setup"):
            if dim == 2:
                return self._setup_2d(inv)
            return self._setup_3d(inv)

    def _setup_3d(self, inv):
        opt, dev = self.settings, self.device
        gopt, fopt = opt["grid"], opt["fourier_transform"]
        real_dtype = _real_dtype(opt)
        fused = _fused_sht(opt)
        if fused and real_dtype == torch.float64:
            # the kernels compute in float32 planes: float64 takes the
            # plain transforms and the stepwise iteration, as in the JAX
            # package, which warns so
            print(f"reconstruct: {FLOAT64_WARNING}")
            fused = False
        qs_data = np.asarray(inv["data_radial_points"], dtype=float)
        L = min(int(gopt["max_order"]), int(inv["max_order"]))
        N = int(gopt["n_radial_points"])
        q_max = float(gopt["max_q"]) if gopt.get("max_q") \
            else float(qs_data.max())
        mode = str(fopt["type"])
        rc = float(fopt["reciprocity_coefficient"])
        weights = load_cached_weights(
            L, N, rc, 3, mode,
            allow_cache=bool(fopt.get("allow_weight_caching", True)),
            allow_calculation=bool(fopt.get("allow_weight_calculation",
                                            True)),
            allow_saving=fopt.get("allow_weight_saving") if self._lead
            else False)
        # fused_bf16_tables: the kernels' bf16 Legendre tables; ignored
        # where no FusedSHT is built (float64, fused_sht false), as in the
        # JAX package (and the 2D set-up never reads it)
        table_dtype = torch.bfloat16 if bool(
            fopt.get("fused_bf16_tables", False)) else None
        ft = SphericalFourierTransform(
            N, L, q_max=q_max, mode=mode, reciprocity_coefficient=rc,
            n_theta=int(gopt.get("n_theta") or 0) or None,
            n_phi=int(gopt.get("n_phi") or 0) or None, weights_dict=weights,
            real_dtype=real_dtype, fused_sht=fused,
            fused_table_dtype=table_dtype, device=dev)
        grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)

        # the data normalised so that the intensity scale is O(1): raw
        # intensities overflow float32 in the quadratic sums; densities are
        # rescaled by √data_scale in the results
        ropt = opt["projections"]["reciprocal"]
        interp = str(ropt.get("regrid", {}).get("interpolation", "linear"))
        proj = regrid_projection_matrices(
            inv["data_projection_matrices"]["I1I1"], qs_data, ft.qs,
            interpolation=interp)
        avg_intensity = _interp_radial(
            np.asarray(inv["average_intensity"], dtype=float), qs_data,
            ft.qs, interp).real
        data_scale = float(max(np.abs(avg_intensity).max(),
                               max(np.abs(v).max() for v in proj), 1e-30))
        proj = [np.asarray(v) / data_scale for v in proj]
        avg_intensity = avg_intensity / data_scale
        used = ropt.get("used_order_ids", "all")
        if isinstance(used, str) and used == "all":
            used_ids = np.arange(L + 1)
        else:
            used_ids = np.asarray(used, dtype=int)
            used_ids = used_ids[used_ids <= L]
        radial_mask = _radial_mask(
            ropt, L, ft.qs, qs_data=qs_data,
            q_id_limits=inv.get("data_projection_matrices_q_id_limits"))
        n0, pn_scan, pn_project, pn_estimate_in = _particle_number(ropt,
                                                                   inv)
        rc_constraint = ReciprocalConstraint.build(
            proj, ft.qs, L, used_order_ids=used_ids,
            odd_orders_to_0=bool(ropt.get("odd_orders_to_0",
                                          ropt.get("assume_zero_odd_orders",
                                                   True))),
            use_averaged_intensity=bool(ropt.get("use_averaged_intensity",
                                                 True)),
            average_intensity=avg_intensity, radial_mask=radial_mask,
            n_particles=float(n0), schmidt_scaling=False,
            procrustes_method=str(ropt.get("procrustes_method",
                                           "newton_schulz")),
            ns_iterations=int(ropt.get("ns_iterations", 16)),
            ns_schedule=_resolve_ns_schedule(ropt), pn_scan_space=pn_scan,
            pn_project=pn_project, real_dtype=real_dtype, device=dev)

        # real constraint and initial support
        real_opt = opt["projections"]["real"]
        popt = real_opt["projections"]
        real_constraint = self._real_constraint(data_scale)
        is_opt = popt.get("support", {}).get("initial_support", {})
        if str(is_opt.get("type", "max_radius")) == "auto_correlation":
            # keep A ≥ threshold·max(A) of the data's synthesis
            # A = iFT(iSHT(V_padded)) (B2 on the card), inside the particle
            # radius; B5 then takes the masked weight grid
            a_thr = float(is_opt.get("auto_correlation", {})
                          .get("threshold", 0.01))
            A = self._synthesize(ft, pad_coeff_dense(proj, N, L)).real \
                .cpu().numpy()
            initial_support = (A >= a_thr * A.max()) \
                & (grid[..., 0] <= float(opt["particle_radius"]))
        else:
            initial_support = grid[..., 0] < float(
                is_opt.get("max_radius", opt["particle_radius"]))
        enforce_opt = popt.get("support", {}).get("enforce_initial_support",
                                                  {})
        enforce_limit = float(enforce_opt.get("if_error_bigger_than",
                                              np.inf)) \
            if enforce_opt.get("apply", False) else np.inf

        integ = SphericalIntegrator(ft.rs, ft.sht.n_theta, ft.sht.n_phi,
                                    real_dtype=real_dtype, device=dev)
        swopt = real_opt["shrink_wrap"]
        fv = swopt.get("fixed_volume", {})
        sw = ShrinkWrap.build(
            ft.qs, mode=str(swopt.get("mode", "threshold")),
            volume_fraction=float(fv.get("volume", 0.5)),
            integration_weights=integ._w.cpu().numpy(),
            initial_support=initial_support,
            fixed_volume_method=str(fv.get("method", "sort")),
            max_volume_change=fv.get("max_volume_change", 0.2),
            real_dtype=real_dtype, device=dev)
        mtip = MTIP(ft, rc_constraint, real_constraint, sw,
                    integ.w_broadcast.cpu().numpy(), initial_support,
                    enforce_initial_support_limit=enforce_limit,
                    fused_pipeline=None if fused else False,
                    error_config=_error_config(opt),
                    best_mode=str(opt["main_loop"].get("best_tracking",
                                                       "replay")),
                    pn_estimate_in=pn_estimate_in, real_dtype=real_dtype,
                    device=dev)
        # SW_center and shift_to_center: the grids' cartesian tables
        mtip.enable_centering(
            spherical_to_cartesian(grid),
            spherical_to_cartesian(spherical_grid(ft.qs, ft.sht.theta,
                                                  ft.sht.phi)))
        guess = self._density_guess(inv, ft, integ, proj, avg_intensity,
                                    data_scale, N, L, qs_data)
        aux = dict(grid=grid, initial_support=initial_support,
                   initial_density_batch=guess["batch"],
                   avg_intensity=avg_intensity,
                   wavelength=inv["xray_wavelength"], proj=proj, rc=rc,
                   total_intensity=guess["total_intensity"], dimensions=3,
                   data_scale=data_scale)
        return mtip, ft, aux

    def _real_constraint(self, data_scale):
        """The real constraint of projections.real; absolute thresholds are
        in physical density units, the state in units of √data_scale."""
        real_opt = self.settings["projections"]["real"]
        popt = real_opt["projections"]
        apply = list(popt.get("apply", ["support", "value_threshold",
                                        "limit_imag"]))
        thr = popt.get("value_threshold", {}).get("threshold", [0, False])
        unit = 1.0 / np.sqrt(data_scale)
        return RealConstraint(
            apply_support="support" in apply,
            apply_value_threshold="value_threshold" in apply,
            threshold_low=None if thr[0] is False else float(thr[0]) * unit,
            threshold_high=float(thr[1]) * unit
            if (len(thr) > 1 and thr[1]) else None,
            apply_limit_imag="limit_imag" in apply,
            limit_imag=float(popt.get("limit_imag", {}).get("threshold", 2.0))
            * unit,
            apply_assert_real="assert_real" in apply,
            considered_projections=tuple(
                real_opt.get("HIO", {}).get("considered_projections",
                                            ["all"]) or ["all"]))

    def _setup_2d(self, inv):
        """The polar (2D) MTIP: circular-harmonic data projection with
        rank-1 vectors v_m, the SO(2) gauge pin on the strongest even order
        under SO_freedom, the stepwise iteration on the worker's device, at
        the settings' precision."""
        opt, dev = self.settings, self.device
        gopt, fopt = opt["grid"], opt["fourier_transform"]
        real_dtype = _real_dtype(opt)
        qs_data = np.asarray(inv["data_radial_points"], dtype=float)
        M = min(int(gopt["max_order"]), int(inv["max_order"]))
        N = int(gopt["n_radial_points"])
        q_max = float(gopt["max_q"]) if gopt.get("max_q") \
            else float(qs_data.max())
        mode = str(fopt["type"])
        rc = float(fopt["reciprocity_coefficient"])
        n_phi = int(gopt.get("n_phi") or 0)
        if n_phi <= 0:
            n_phi = 2 ** int(np.ceil(np.log2(2 * (M + 1))))
        weights = load_cached_weights(
            M, N, rc, 2, mode,
            allow_cache=bool(fopt.get("allow_weight_caching", True)),
            allow_calculation=bool(fopt.get("allow_weight_calculation",
                                            True)),
            allow_saving=fopt.get("allow_weight_saving") if self._lead
            else False)
        ft = PolarFourierTransform(N, M, n_phi, q_max, mode=mode,
                                   reciprocity_coefficient=rc,
                                   weights_dict=weights,
                                   real_dtype=real_dtype, device=dev)
        phis = 2 * np.pi * np.arange(n_phi) / n_phi
        grid = polar_grid(ft.rs, phis)

        ropt = opt["projections"]["reciprocal"]
        interp = str(ropt.get("regrid", {}).get("interpolation", "linear"))
        proj = regrid_projection_matrices(
            inv["data_projection_matrices"]["I1I1"], qs_data, ft.qs,
            interpolation=interp)
        proj = [np.asarray(v).reshape(len(ft.qs), -1)[:, 0] for v in proj]
        avg_intensity = _interp_radial(
            np.asarray(inv["average_intensity"], dtype=float), qs_data,
            ft.qs, interp).real
        data_scale = float(max(np.abs(avg_intensity).max(),
                               max(np.abs(v).max() for v in proj), 1e-30))
        proj = [np.asarray(v) / data_scale for v in proj]
        avg_intensity = avg_intensity / data_scale
        used = ropt.get("used_order_ids", "all")
        if isinstance(used, str) and used == "all":
            used_ids = np.arange(M + 1)
        else:
            used_ids = np.asarray(used, dtype=int)
            used_ids = used_ids[used_ids <= M]
        so_pin = None
        so_opt = ropt.get("SO_freedom", {})
        if bool(so_opt.get("use", so_opt.get("apply", False))):
            # pin the strongest even nonzero order
            lo = int((len(ft.qs) - 1) * float(so_opt.get("radial_high_pass",
                                                         0.2)))
            scores = [np.abs(np.asarray(v)[lo:]).sum()
                      if (m % 2 == 0 and m > 0) else -1.0
                      for m, v in enumerate(proj)]
            so_pin = int(np.argmax(scores))
        # the particle-number estimate is not built in 2D, as in the JAX
        # package (its initial value only)
        n0 = _particle_number(ropt, inv)[0]
        rc_constraint = ReciprocalConstraintPolar.build(
            proj, ft.qs, M, used_order_ids=used_ids, so_pin_order=so_pin,
            odd_orders_to_0=bool(ropt.get("odd_orders_to_0",
                                          ropt.get("assume_zero_odd_orders",
                                                   True))),
            use_averaged_intensity=bool(ropt.get("use_averaged_intensity",
                                                 True)),
            average_intensity=avg_intensity,
            radial_mask=_radial_mask(
                ropt, M, ft.qs, qs_data=qs_data,
                q_id_limits=inv.get("data_projection_matrices_q_id_limits")),
            n_particles=float(n0), real_dtype=real_dtype, device=dev)

        real_opt = opt["projections"]["real"]
        popt = real_opt["projections"]
        support_radius = float(popt.get("support", {}).get(
            "initial_support", {}).get("max_radius", opt["particle_radius"]))
        initial_support = grid[..., 0] < support_radius
        enforce_opt = popt.get("support", {}).get("enforce_initial_support",
                                                  {})
        enforce_limit = float(enforce_opt.get("if_error_bigger_than",
                                              np.inf)) \
            if enforce_opt.get("apply", False) else np.inf
        integ = PolarIntegrator(ft.rs, n_phi, real_dtype=real_dtype,
                                device=dev)
        w_grid = integ._w.cpu().numpy()
        swopt = real_opt["shrink_wrap"]
        fv = swopt.get("fixed_volume", {})
        sw = ShrinkWrap.build(
            ft.qs, mode=str(swopt.get("mode", "threshold")),
            volume_fraction=float(fv.get("volume", 0.5)),
            integration_weights=w_grid, initial_support=initial_support,
            fixed_volume_method=str(fv.get("method", "sort")),
            max_volume_change=fv.get("max_volume_change", 0.2), grid_rank=2,
            real_dtype=real_dtype, device=dev)
        # the error config is parsed as in 3D; replay resolves to eager
        # (the stepwise iteration), as in the JAX package
        mtip = MTIP(ft, rc_constraint, self._real_constraint(data_scale), sw,
                    w_grid * initial_support, initial_support,
                    enforce_initial_support_limit=enforce_limit,
                    error_config=_error_config(opt),
                    best_mode=str(opt["main_loop"].get("best_tracking",
                                                       "replay")),
                    harmonic=RealCircularHarmonics(n_phi, M),
                    real_dtype=real_dtype, device=dev)
        # SW_center and shift_to_center: the polar grids' cartesian tables
        mtip.enable_centering(spherical_to_cartesian(grid),
                              spherical_to_cartesian(polar_grid(ft.qs, phis)))

        total_intensity = float(np.trapezoid(avg_intensity * ft.qs, ft.qs)
                                * 2 * np.pi)
        gopt_g = opt["density_guess"]
        radius = float(gopt_g.get("radius", opt["particle_radius"]))
        if str(gopt_g.get("type", "bump")) == "ball":
            bump = (ft.rs < radius).astype(float)
        else:
            bump = get_test_function(support=[-radius, radius],
                                     slope=float(gopt_g.get("bump", {})
                                                 .get("slope", 0.3)))(ft.rs)
        snr = float(gopt_g.get("random", {}).get("SNR", 2.0))
        if str(gopt_g.get("amplitude_function", "random")) != "random":
            snr = float("inf")  # uniform amplitude: the bare envelope

        def batch(seed, n):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            rho0 = bump_density_guess(gen, bump, (N, n_phi), snr=snr,
                                      total_intensity=total_intensity,
                                      integration_weights=integ._w,
                                      n_restarts=n, real_dtype=real_dtype)
            return ft.inverse(ft.forward(rho0))

        aux = dict(grid=grid, initial_support=initial_support,
                   initial_density_batch=batch, avg_intensity=avg_intensity,
                   wavelength=inv["xray_wavelength"], proj=proj, rc=rc,
                   total_intensity=total_intensity, dimensions=2, phis=phis,
                   data_scale=data_scale, so_pin=so_pin,
                   so_radial_high_pass=float(so_opt.get("radial_high_pass",
                                                        0.2)))
        return mtip, ft, aux

    @staticmethod
    def _synthesize(ft, dense):
        """iFT(iSHT(c)) of host coefficients (n_q, 2L+1, L+1) → the real
        grid, on ft's device at its precision."""
        c = torch.as_tensor(dense, device=ft.sht.device).to(ft.complex_dtype)
        return ft.inverse(ft.harmonic.inverse(c))

    def _density_guess(self, inv, ft, integ, proj, avg_intensity, data_scale,
                       N, L, qs_data):
        """initial_density_batch(seed, n): n random densities from a
        torch.Generator seeded with `seed` on the device, smoothed by an FT
        round trip; 'bump' or 'ball' envelopes in r, or the low-resolution
        autocorrelation envelope."""
        opt, dev = self.settings, self.device
        total_intensity = float(np.trapezoid(avg_intensity * ft.qs ** 2,
                                             ft.qs) * 2 * np.sqrt(np.pi))
        gopt = opt["density_guess"]
        gtype = str(gopt.get("type", "bump"))
        radius = float(gopt.get("radius", opt["particle_radius"]))
        if gtype == "ball":
            bump = (ft.rs < radius).astype(float)
        elif gtype == "low_resolution_autocorrelation":
            bump = get_test_function(support=[-radius, radius],
                                     slope=float(gopt.get("bump", {})
                                                 .get("slope", 0.1)))(ft.rs)
        else:
            bump = get_test_function(support=[-radius, radius],
                                     slope=float(gopt.get("bump", {})
                                                 .get("slope", 0.3)))(ft.rs)
        snr = float(gopt.get("random", {}).get("SNR", 2.0))
        if str(gopt.get("amplitude_function", "random")) != "random":
            snr = float("inf")  # uniform amplitude: the bare envelope
        real_dtype = ft.real_dtype
        w = integ.w_broadcast
        shape = (N, ft.sht.n_theta, ft.sht.n_phi)

        def generator(seed):
            return torch.Generator(device=dev).manual_seed(int(seed))

        if gtype == "low_resolution_autocorrelation":
            # ρ₀ ∝ clip(iFT(iSHT(V_low)), 0)·(1 + U/SNR)·bump(r), scaled to
            # the total intensity
            lr = inv.get("data_low_resolution_intensity_coefficients")
            if lr is None:
                raise KeyError(
                    "density_guess.type=low_resolution_autocorrelation needs "
                    "'data_low_resolution_intensity_coefficients' in the "
                    "invariants file")
            if isinstance(lr, dict):  # per-l matrices
                lr_list = [np.atleast_2d(np.asarray(lr[k]))
                           for k in sorted(lr, key=int)]
            elif isinstance(lr, list):
                lr_list = [np.atleast_2d(np.asarray(v)) for v in lr]
            else:  # the isotropic vector I_00
                lr_list = [np.asarray(lr, dtype=complex)[:, None]]
            lr_list = regrid_projection_matrices(
                lr_list, qs_data, ft.qs,
                interpolation=str(opt["projections"]["reciprocal"]
                                  .get("regrid", {})
                                  .get("interpolation", "linear")))
            env = torch.clamp(self._synthesize(
                ft, pad_coeff_dense(lr_list, N, L) / data_scale).real,
                min=0.0) * torch.as_tensor(bump, device=dev).to(
                    real_dtype)[:, None, None]

            def batch(seed, n):
                amp = 1.0 + torch.rand((n,) + shape,
                                       generator=generator(seed),
                                       device=dev) / snr
                rho = env * amp.to(real_dtype)
                tot = torch.sum(w * rho * rho, dim=(-3, -2, -1),
                                keepdim=True)
                rho = (rho * torch.sqrt(total_intensity / tot)).to(
                    ft.complex_dtype)
                return ft.inverse(ft.forward(rho))
        else:
            def batch(seed, n):
                rho0 = bump_density_guess(generator(seed), bump, shape,
                                          snr=snr,
                                          total_intensity=total_intensity,
                                          integration_weights=w,
                                          n_restarts=n,
                                          real_dtype=real_dtype)
                return ft.inverse(ft.forward(rho0))
        return {"batch": batch, "total_intensity": total_intensity}

    def _build_schedule(self, ft):
        return _build_schedule(self.settings, ft)

    # ------------------------------------------------------------ result save
    def _collect_results(self, mtip, ft, aux, states, errors, order, seed,
                         rho0s=None):
        """The kept restarts in rank order on the host, in the JAX
        package's layout: densities rescaled by √data_scale (centered under
        output_density_modifiers.shift_to_center; in 2D rotated under
        fix_orientation by the residual SO(2) angle of their unknowns),
        finalize's ψ_p and W, masks, the error curves and the best
        restart's deg-2 fidelity."""
        opt = self.settings
        dim = aux.get("dimensions", 3)
        keep = opt["multi_start"].get("results_to_keep", "all")
        ids = order if (isinstance(keep, str) and keep == "all") \
            else order[: int(keep)]
        errors_h = errors.cpu().numpy()
        sqrt_s = float(np.sqrt(aux.get("data_scale", 1.0)))
        center_out = bool(opt.get("output_density_modifiers", {})
                          .get("shift_to_center", False)) \
            and mtip._r_cart is not None
        # fix_orientation needs the in-loop SO(2) pin; without it the JAX
        # package warns and skips, as here
        fix_orient = dim == 2 and aux.get("so_pin") is not None \
            and bool(opt.get("output_density_modifiers", {})
                     .get("fix_orientation", False))
        best_err_h = states.best_err.cpu().numpy()
        idx = torch.as_tensor(np.asarray(ids, dtype=np.int64),
                              device=self.device)
        rho_b = states.best_rho[idx]
        last_b = states.rho[idx]
        if center_out:
            rho_b = mtip._center_density(rho_b)
            last_b = mtip._center_density(last_b)
        psi_b, W_b = mtip.finalize(rho_b)
        rho_bh, last_bh = rho_b.cpu().numpy(), last_b.cpu().numpy()
        psi_bh, W_bh = psi_b.cpu().numpy(), W_b.cpu().numpy()
        del rho_b, last_b, psi_b, W_b
        init_bh = rho0s[idx].cpu().numpy() if rho0s is not None else None
        bm_bh = states.best_mask[idx].cpu().numpy()
        sm_bh = states.support[idx].cpu().numpy()
        init_sup_h = np.asarray(aux["initial_support"])

        results = {}
        for rank, i in enumerate(ids):
            i = int(i)
            if fix_orient:
                phi0 = so2_residual_rotation_phase(
                    W_bh[rank], aux["proj"], ft.qs,
                    aux.get("so_radial_high_pass", 0.2))
                if phi0:
                    for arr in (rho_bh, last_bh, psi_bh):
                        arr[rank] = rotate_polar_density(arr[rank], phi0)
            results[str(rank)] = {
                "real_density": rho_bh[rank] * sqrt_s,
                "last_real_density": last_bh[rank] * sqrt_s,
                "reciprocal_density": psi_bh[rank] * sqrt_s,
                "support_mask": bm_bh[rank],
                "last_support_mask": sm_bh[rank],
                "initial_density": init_bh[rank] * sqrt_s
                if init_bh is not None else None,
                "initial_support": init_sup_h,
                "fxs_unknowns": W_bh[rank],
                "error_dict": {"main": errors_h[i][:, 0],
                               "reciprocal": errors_h[i][:, 1],
                               "final": float(best_err_h[i]),
                               # each configured metric's curve
                               **{nm: errors_h[i][:, j] for j, nm
                                  in enumerate(mtip.error_names)
                                  if j >= 2 + int(mtip._pn_enabled)}},
                "n_particles": float(mtip.rc.n_particles),
            }
            if mtip._pn_enabled:
                hist = errors_h[i][:, 2]
                results[str(rank)]["n_particles_history"] = hist
                if len(hist):
                    results[str(rank)]["n_particles"] = float(hist[-1])
        # the best restart's deg-2 fidelity: relative difference of its
        # B_l to the data's B_l = V_l V_l†, even l (in 2D of |B_m| to
        # |v_m v_m†|)
        if results and dim == 2:
            best = results["0"]
            rho_n = best["real_density"] / max(sqrt_s, 1e-30)
            psi = ft.forward(torch.as_tensor(rho_n, device=self.device).to(
                ft.complex_dtype))
            bm_rec = itools.harmonic_coeff_to_deg2_invariants_2d(
                mtip.sht.forward((psi * psi.conj()).real)).cpu().numpy()
            diffs = []
            for m in range(0, bm_rec.shape[0], 2):
                v = np.asarray(aux["proj"][m]).reshape(-1)
                bm_data = np.outer(v, v.conj())
                scale = np.abs(bm_data).max()
                if scale > 0:
                    diffs.append(np.abs(np.abs(bm_rec[m]) - np.abs(bm_data))
                                 .mean() / scale)
            best["error_dict"]["deg2_invariant_relative"] = \
                np.asarray(diffs, dtype=np.float32)
        elif results:
            best = results["0"]
            rho_n = best["real_density"] / max(sqrt_s, 1e-30)
            r = torch.as_tensor(rho_n, device=self.device).to(
                ft.complex_dtype)
            psi = ft.forward(r)
            coeff = mtip.sht.forward_real((psi * psi.conj()).real)
            bl_rec = itools.harmonic_coeff_to_deg2_invariants_3d(
                coeff.cpu().numpy())
            bl_data = itools.projection_matrices_to_deg2_invariant_3d(
                aux["proj"])
            diffs = []
            for l in range(0, min(len(bl_data), bl_rec.shape[0]), 2):
                scale = np.abs(bl_data[l]).max()
                if scale > 0:
                    diffs.append(np.abs(bl_rec[l] - bl_data[l]).mean()
                                 / scale)
            best["error_dict"]["deg2_invariant_relative"] = \
                np.asarray(diffs, dtype=np.float32)
        grid_cfg = {"real_grid": np.asarray(ft.rs),
                    "reciprocal_grid": np.asarray(ft.qs)}
        if dim == 3:
            grid_cfg.update(thetas=np.asarray(ft.sht.theta),
                            phis=np.asarray(ft.sht.phi))
        else:
            grid_cfg["phis"] = np.asarray(aux["phis"])
        return {
            "configuration": {
                "internal_grid": grid_cfg,
                "dimensions": dim,
                "reciprocity_coefficient": aux["rc"],
                "xray_wavelength": float(aux["wavelength"]),
                "max_order": ft.sht.l_max if dim == 3 else ft.m_max,
                "fourier_transform_mode": ft.mode,
                "q_max": float(ft.q_max),
                "seed": int(seed),
            },
            "projection_matrices": [np.asarray(v) * aux.get("data_scale", 1.0)
                                    for v in aux["proj"]],
            "average_intensity": np.asarray(aux["avg_intensity"])
            * aux.get("data_scale", 1.0),
            "reconstruction_results": results,
        }
