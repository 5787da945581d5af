"""Multi-start runners for MTIP phasing, on one card or over a device
mesh.

Port of `xframe_tpu.parallel.mesh`. `MultiStartRunner` runs a whole
schedule with the restarts as the leading batch axis of one MTIP run;
`CheckpointingRunner` runs it in chunks that end at shrink-wrap boundaries
and writes the batched PhasingState to disk between chunks, so that a later
call resumes where an earlier one stopped. `rank_restarts` orders the
restarts by their best error.

A checkpoint holds host copies of the state's fields
(`convert.state_arrays`: the replay anchors and the linked ft-stab history
among them), the index of the next chunk and the errors so far. A path
ending in `.h5` gives the JAX package's HDF5 checkpoint (complex fields as
`<name>_re` and `<name>_im`; a JAX checkpoint resumes here), any other a
numpy `.npz` archive; it is written to `<path>.tmp` and then
moved over `<path>`, so a reader never finds half a file.

The device mesh. `make_mesh` lays devices out on named axes as the JAX
mesh does; a device may repeat, so that two ranks can share one card (or
the CPU). Where the JAX package shards the restart axis of one SPMD
program (`shard_map`, no collective inside the iteration), the port runs
one process per device, a rank: each builds the worker's MTIP on its own
device, computes the chunk's whole batch of initial densities, runs its
contiguous rows of the wrap-padded batch (`_pad_restarts`: rank d takes
rows [d·b, (d+1)·b)) and sends host copies of its states and errors to
rank 0 over a gloo process group (`Mesh.gather`), field by field; rank 0
trims the padding. Gloo serves every layout: cards of one host, CPU
processes, and two ranks sharing one card, which NCCL refuses.
`run_ranks` starts the ranks from one process, which is rank 0 (the others
are spawned, never forked, since CUDA may already be initialised here);
`world_mesh` joins the ranks that torchrun started (`--distributed`). A
rank that raises ends its process; the others' next exchange with it
raises, and `run_ranks` raises naming the rank. Nothing carries on with
fewer restarts.

A mesh with a θ axis, {"restarts": R, "theta": T}, is the JAX package's
P('restarts', None, 'theta', None) layout of the plain transforms: rank
r·T + t holds restart group r's rows of the batch and θ block t of the
grid (`Mesh.theta_rows`, GSPMD's blocks of ⌈n_θ/T⌉ rows). The runners
run the MTIP's θ shard there (`MTIP.theta_shard`): every analysis and
every reduction over the grid is summed (max, min) over the T ranks of
the group (`Mesh.all_reduce`, a gloo process group per restart group),
where GSPMD adds its psum, so that the coefficients and every value a
decision is taken on are the same bits on the group's ranks. The state
gathered to rank 0 and the checkpoints hold the whole grid, the one-card
layout.
"""
from __future__ import annotations

import datetime
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from xframe_tpu_torch.convert import state_arrays, state_from_numpy
from xframe_tpu_torch.io import hdf5

_MARKERS = ("SW", "SW_center", "SNAPSHOT", "RESET_TO_BEST")
# the state's fields on the grid: a θ rank holds its θ rows of them
GRID_FIELDS = ("rho", "support", "best_rho", "best_mask", "anchor_rho",
               "anchor_sup")
# how long a rank waits for the others: to join the group, and at an
# exchange (a rank waits there until the slowest has run its share)
JOIN_TIMEOUT = datetime.timedelta(minutes=10)
EXCHANGE_TIMEOUT = datetime.timedelta(hours=24)
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


# ------------------------------------------------------------------ mesh
def visible_devices():
    """Every CUDA device of this process, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class Mesh:
    """Devices on named axes: `devices` a numpy object array of torch
    devices shaped by the axes, `axis_names` their names. A rank's mesh
    (`run_ranks`, `world_mesh`) also knows its `rank`, its coordinates
    (`restart_index`, `theta_index`: rank = restart_index·n_theta +
    theta_index) and exchanges data with the other ranks over the process
    group. `exchanges` sums this rank's exchanges by name: {name: {count,
    bytes, seconds, wait_seconds}}; `seconds` moving the data, and
    `wait_seconds` waiting before it: for the rank's gathers until the
    other ranks reach the gather, for the θ all-reduces and all-gathers
    until the card has computed the tensor (the copy to the host)."""

    def __init__(self, devices, axis_names, rank=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.exchanges = {}
        self._theta_group = None
        self._staging = {}

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def device(self):
        """This rank's device."""
        return self.devices.reshape(-1)[self.rank]

    @property
    def n_theta(self):
        """The ranks along θ: 1 without a θ axis."""
        return int(self.shape.get("theta", 1))

    @property
    def restart_index(self):
        return self.rank // self.n_theta

    @property
    def theta_index(self):
        return self.rank % self.n_theta

    def rows(self, n):
        """This rank's rows of an n-row batch wrap-padded to a multiple of
        the restart groups (`_pad_restarts`): [g·b, (g+1)·b) of the padded
        batch for restart group g, as indices into the unpadded one. The
        θ ranks of a group hold the same rows."""
        g = self.size // self.n_theta
        b = -(-n // g)
        r = self.restart_index
        return np.arange(r * b, (r + 1) * b) % n

    def theta_rows(self, n_theta, index=None):
        """The θ rows of θ coordinate `index` (default this rank's) of an
        n_theta-row grid, as GSPMD lays out P(..., 'theta', ...): blocks
        of ⌈n_theta/T⌉ rows, the last shorter (or empty) where T does not
        divide n_theta. → a slice."""
        t = self.theta_index if index is None else int(index)
        block = -(-int(n_theta) // self.n_theta)
        a = min(t * block, int(n_theta))
        return slice(a, min(a + block, int(n_theta)))

    def local(self, batch, theta=True):
        """This rank's rows of a whole batch (n, ..., θ, φ), a tensor or an
        array, and with `theta` on a θ axis its θ rows (axis -2)."""
        rows = self.rows(int(batch.shape[0]))
        if isinstance(batch, torch.Tensor):
            out = batch[torch.as_tensor(rows, device=batch.device)]
        else:
            out = np.asarray(batch)[rows]
        if theta and self.n_theta > 1:
            out = out[..., self.theta_rows(out.shape[-2]), :]
        return out

    def with_axes(self, axis_sizes):
        """This rank's mesh with its devices laid out on {name: size} (the
        sizes' product the rank count), its θ groups joined: every rank
        calls it, in the same order. → self where the layout is this one,
        else a new Mesh."""
        shape = tuple(int(v) for v in axis_sizes.values())
        if int(np.prod(shape)) != self.size:
            raise ValueError(f"mesh: {self.size} ranks cannot be laid out "
                             f"as {dict(axis_sizes)}")
        if tuple(axis_sizes) == self.axis_names \
                and shape == self.devices.shape:
            return self.join_theta_groups()
        return Mesh(self.devices.reshape(shape), tuple(axis_sizes),
                    self.rank).join_theta_groups()

    # ------------------------------------------------------------ exchanges
    def _log(self, name, nbytes, seconds, wait_seconds):
        e = self.exchanges.setdefault(name, {"count": 0, "bytes": 0,
                                             "seconds": 0.0,
                                             "wait_seconds": 0.0})
        e["count"] += 1
        e["bytes"] += int(nbytes)
        e["seconds"] += seconds
        e["wait_seconds"] += wait_seconds

    def join_theta_groups(self):
        """Create the θ process group of every restart group, in the same
        order on every rank (`new_group` is collective over all ranks), and
        keep this rank's. A no-op without θ ranks. → self."""
        t = self.n_theta
        if t > 1 and self._theta_group is None:
            for g in range(self.size // t):
                group = dist.new_group(list(range(g * t, (g + 1) * t)),
                                       timeout=EXCHANGE_TIMEOUT,
                                       backend="gloo")
                if g == self.restart_index:
                    self._theta_group = group
        return self

    def _to_host(self, wire):
        """A host copy of `wire` that the collective may overwrite: on the
        card a pinned staging buffer of its shape (reused), on the CPU a
        contiguous copy."""
        if wire.device.type == "cpu":
            return wire.clone(memory_format=torch.contiguous_format)
        key = (tuple(wire.shape), wire.dtype)
        host = self._staging.get(key)
        if host is None:
            host = self._staging[key] = torch.empty(
                wire.shape, dtype=wire.dtype, pin_memory=True)
        host.copy_(wire)
        return host

    def all_reduce(self, tensor, op="sum", name="all_reduce"):
        """`tensor` summed (op "sum"), or its largest or smallest entries
        ("max", "min"), over this rank's θ group: → a new tensor on the
        tensor's device, the same bits on every rank of the group. Without
        θ ranks the tensor itself, no work. Gloo moves host tensors: a
        card's tensor is staged through a pinned host buffer explicitly,
        whether or not the installed gloo takes CUDA tensors, and complex
        tensors travel as their real views. An exchange that fails raises
        on every rank: no rank carries on alone."""
        if self._theta_group is None:
            return tensor
        t0 = time.perf_counter()
        wire = torch.view_as_real(tensor.resolve_conj()) \
            if tensor.is_complex() else tensor
        host = self._to_host(wire)
        t1 = time.perf_counter()
        dist.all_reduce(host, op=_REDUCE_OPS[op], group=self._theta_group)
        out = host if wire.device.type == "cpu" else \
            torch.empty_like(wire).copy_(host)
        self._log(name, host.numel() * host.element_size(),
                  time.perf_counter() - t1, t1 - t0)
        return torch.view_as_complex(out) if tensor.is_complex() else out

    def all_gather_theta(self, tensor, n_theta, name="all_gather_theta"):
        """This rank's θ rows (axis -2) of an n_theta-row grid, a real or
        bool tensor → the whole grid's, joined over this rank's θ group,
        on the tensor's device. Without θ ranks the tensor itself."""
        if self._theta_group is None:
            return tensor
        t0 = time.perf_counter()
        ax = tensor.dim() - 2
        wire = tensor.to(torch.uint8) if tensor.dtype == torch.bool \
            else tensor
        block = self.theta_rows(n_theta, 0).stop
        pad = block - wire.shape[ax]
        if pad:
            shape = list(wire.shape)
            shape[ax] = pad
            wire = torch.cat([wire, wire.new_zeros(shape)], dim=ax)
        host = self._to_host(wire)
        t1 = time.perf_counter()
        parts = [torch.empty_like(host) for _ in range(self.n_theta)]
        dist.all_gather(parts, host, group=self._theta_group)
        full = torch.cat([p.narrow(ax, 0, len(range(n_theta)[
            self.theta_rows(n_theta, t)])) for t, p in enumerate(parts)],
            dim=ax).to(tensor.device)
        self._log(name, host.numel() * host.element_size() * self.n_theta,
                  time.perf_counter() - t1, t1 - t0)
        return full.to(torch.bool) if tensor.dtype == torch.bool else full

    def gather(self, arrays, name="gather", n_theta=None):
        """{field: host array} of equal shapes on every rank → on rank 0
        the ranks' arrays of each field concatenated along axis 0 in rank
        order, elsewhere None. One field at a time, so that no rank holds
        more than one field's wire copy. On a θ axis (n_theta: the grid's θ
        rows) the fields of GRID_FIELDS are this rank's θ rows (axis -2):
        rank 0 joins each restart group's blocks along θ; every other
        field, which the θ ranks of a group hold alike, is taken from the
        group's first θ rank, and rank 0 raises if another one's bits
        differ."""
        t_wait = time.perf_counter()
        dist.barrier()
        t0, nbytes = time.perf_counter(), 0
        t = self.n_theta if n_theta is not None else 1
        out = {} if self.rank == 0 else None
        for key, a in arrays.items():
            # gloo moves real tensors: complex as its (re, im) pairs, bool
            # as bytes
            a = np.ascontiguousarray(a)
            on_grid = t > 1 and key in GRID_FIELDS
            if on_grid:             # every rank sends a whole θ block
                block = self.theta_rows(n_theta, 0).stop
                pad = [(0, 0)] * a.ndim
                pad[-2] = (0, block - a.shape[-2])
                a = np.pad(a, pad)
            wire = torch.from_numpy(
                a.view(a.real.dtype) if np.iscomplexobj(a) else
                a.view(np.uint8) if a.dtype == bool else a)
            parts = [torch.empty_like(wire) for _ in range(self.size)] \
                if self.rank == 0 else None
            dist.gather(wire, parts, dst=0)
            nbytes += wire.numel() * wire.element_size() * self.size
            if self.rank != 0:
                continue
            parts = [p.numpy().view(a.dtype) for p in parts]
            if t > 1:
                parts = [self._join_group(parts[g * t:(g + 1) * t], key,
                                          n_theta, on_grid)
                         for g in range(self.size // t)]
            out[key] = np.concatenate(parts)
        self._log(name, nbytes, time.perf_counter() - t0, t0 - t_wait)
        return out

    def _join_group(self, parts, key, n_theta, on_grid):
        """The T θ ranks' arrays of one restart group → the group's: θ
        blocks joined along axis -2, else the first rank's, every rank's
        bits equal."""
        if on_grid:
            return np.concatenate(
                [p[..., :len(range(n_theta)[self.theta_rows(n_theta, i)]), :]
                 for i, p in enumerate(parts)], axis=-2)
        for p in parts[1:]:
            if p.tobytes() != parts[0].tobytes():
                raise RuntimeError(
                    f"mesh: the θ ranks of a restart group hold different "
                    f"{key!r}: a decision was taken on values that differ "
                    "between the ranks")
        return parts[0]

    def gather_objects(self, obj):
        """Picklable obj of every rank → the list in rank order on rank 0,
        None elsewhere."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out

    def broadcast(self, obj):
        """Rank 0's picklable obj on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def all_true(self, flag):
        """True on every rank iff flag is true on every rank."""
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def gather_state(self, state, errors, n, counts=None, n_theta=None):
        """A PhasingState and its errors of this rank's rows (on a θ axis
        its θ rows of an n_theta-row grid) → on rank 0 the whole batch's on
        the whole grid, the one-card layout, padding trimmed to the first n
        rows, on rank 0's device, and every rank's `counts` (launch counts,
        in rank order); elsewhere (None, None, None). The host copies are
        taken before the exchange: replay's anchors may share memory with
        a state that runs on."""
        arrays = {k: np.array(v) for k, v in state_arrays(state).items()}
        arrays["errors"] = errors.cpu().numpy()
        got = self.gather(arrays, name="state", n_theta=n_theta)
        counts = self.gather_objects(counts)
        if self.rank != 0:
            return None, None, None
        got = {k: v[:n] for k, v in got.items()}
        errors = torch.as_tensor(got.pop("errors"), device=self.device)
        return state_from_numpy(device=self.device, **got), errors, counts


def make_mesh(axis_sizes: dict | None = None, devices=None) -> Mesh:
    """A Mesh from {'axis_name': size}, on the first devices of `devices`
    (default: visible_devices()). Default: every device on 'restarts'."""
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = {"restarts": len(devices)}
    names = tuple(axis_sizes)
    shape = tuple(int(v) for v in axis_sizes.values())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, have "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape), names)


def default_mesh_axes(n_devices: int) -> dict:
    """dp×tp factorization: θ-shard over 2 devices when the count allows,
    restarts over the rest."""
    if n_devices % 2 == 0 and n_devices > 2:
        return {"restarts": n_devices // 2, "theta": 2}
    return {"restarts": n_devices}


def _pad_restarts(batch, n_shards: int):
    """Pad the leading (restart) axis to a multiple of n_shards with
    wrap-around copies (also covers n_restarts < n_shards)."""
    n = int(batch.shape[0])
    if n % n_shards == 0:
        return batch
    idx = np.arange(-(-n // n_shards) * n_shards) % n
    if isinstance(batch, torch.Tensor):
        return batch[torch.as_tensor(idx, device=batch.device)]
    return np.asarray(batch)[idx]


# ------------------------------------------------------------------ ranks
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(store, rank, devices, axes):
    """Join the gloo group of len(devices) ranks as `rank`. → its Mesh on
    the axes {name: size} (the θ groups joined)."""
    store.set(f"mesh/joined/{rank}", "1")
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=len(devices),
                            timeout=EXCHANGE_TIMEOUT)
    return Mesh(devices, ("restarts",), rank).with_axes(axes)


def _rank_main(rank, port, devices, axes, threads, fn, args):
    """A spawned rank: its device current, the launcher's intra-op thread
    count (CPU sums then split as the launcher's do), in the group,
    fn(mesh, *args). An exception ends the process with a non-zero code
    (multiprocessing prints its traceback)."""
    torch.set_num_threads(threads)
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    store = dist.TCPStore("127.0.0.1", port, len(devices), False,
                          timeout=JOIN_TIMEOUT)
    mesh = _join(store, rank, devices, axes)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(mesh, fn, *args):
    """Run fn(rank_mesh, *args) on every device of `mesh` (flattened), one
    process each: this process is rank 0 on the first device, the others
    are spawned. fn is a module-level function (the spawned ranks import
    it by name). The kernels are built here first, so that the ranks do not
    all compile. → rank 0's return value. If any rank fails, the others are
    stopped and this raises: rank 0's own exception, or a RuntimeError
    naming the rank that exited non-zero."""
    if dist.is_initialized():
        raise RuntimeError("run_ranks: a process group is already "
                           "initialised in this process (--distributed "
                           "runs the ranks that torchrun started)")
    devices = [torch.device(d) for d in mesh.devices.reshape(-1)]
    if any(d.type == "cuda" for d in devices):
        from xframe_tpu_torch.ops import _build
        _build.library()
    port = _free_port()
    store = dist.TCPStore("127.0.0.1", port, len(devices), True,
                          timeout=JOIN_TIMEOUT, wait_for_workers=False)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, port, devices, mesh.shape,
                               torch.get_num_threads(), fn, args))
             for r in range(1, len(devices))]
    for p in procs:
        p.start()
    stopped, error, out = set(), None, None
    hook = sys.excepthook          # the process group wraps it per rank
    try:
        _wait_joined(store, procs)
        if devices[0].type == "cuda":
            torch.cuda.set_device(devices[0])
        rank_mesh = _join(store, 0, devices, mesh.shape)
        out = fn(rank_mesh, *args)
    except BaseException as exc:       # re-raised below, after the ranks
        error = exc
        for r, p in enumerate(procs, 1):
            if p.is_alive():
                p.terminate()
                stopped.add(r)
    finally:
        for p in procs:
            p.join()
        if dist.is_initialized():
            dist.destroy_process_group()
        sys.excepthook = hook
    failed = [(r, p.exitcode) for r, p in enumerate(procs, 1)
              if p.exitcode != 0 and r not in stopped]
    if failed:
        r, code = failed[0]
        raise RuntimeError(f"mesh: rank {r} of {len(devices)} on "
                           f"{devices[r]} failed (exit code {code}); its "
                           "traceback is above") from error
    if error is not None:
        raise error
    return out


def _wait_joined(store, procs):
    """Wait until every spawned rank has reached the group; raise naming a
    rank that exited before."""
    deadline = time.monotonic() + JOIN_TIMEOUT.total_seconds()
    keys = [f"mesh/joined/{r}" for r in range(1, len(procs) + 1)]
    while not all(store.check([k]) for k in keys):
        for r, p in enumerate(procs, 1):
            if p.exitcode is not None:
                raise RuntimeError(f"mesh: rank {r} exited with code "
                                   f"{p.exitcode} before joining")
        if time.monotonic() > deadline:
            raise TimeoutError("mesh: the ranks did not join within "
                               f"{JOIN_TIMEOUT}")
        time.sleep(0.05)


def world_mesh(rank, world_size, local_rank, device="cuda"):
    """Join the ranks that torchrun started (MASTER_ADDR, MASTER_PORT in
    the environment): this process takes cuda:local_rank, or the CPU where
    `device` is the CPU. → its Mesh of world_size devices."""
    dev = torch.device("cpu") if torch.device(device).type == "cpu" \
        else torch.device("cuda", int(local_rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="env://", rank=int(rank),
                            world_size=int(world_size),
                            timeout=EXCHANGE_TIMEOUT)
    names = [None] * int(world_size)
    dist.all_gather_object(names, str(dev))
    return Mesh([torch.device(d) for d in names], ("restarts",), int(rank))


def launch_counts(mtip):
    """The kernel launches made through `mtip`'s SHT and fused iteration,
    and the projection kernels' in this process: {counter: launches}, 0
    for a kernel that `mtip` has none of (a plain transform, the stepwise
    iteration, the other table dtype's forms)."""
    from xframe_tpu_torch.ops import fused_mtip, fused_projection, fused_sht
    counts = dict.fromkeys(fused_sht.METHODS + fused_sht.BF16_METHODS
                           + fused_mtip.METHODS + fused_mtip.BF16_METHODS, 0)
    for obj in (getattr(mtip.ft, "harmonic", None), mtip._fi):
        counts.update(getattr(obj, "launches", {}))
    counts.update(fused_projection.launches)
    return counts


def _launches_since(mtip, base):
    """launch_counts(mtip) less the counts `base` taken earlier: the
    launches in between (the projection kernels' counts are the
    process's)."""
    return {k: v - base.get(k, 0) for k, v in launch_counts(mtip).items()}


# -------------------------------------------------------------- runners
def _rank_mtip(mtip, mesh):
    """The MTIP a rank of `mesh` runs: on a θ axis its θ shard (made here
    from a whole MTIP), else `mtip`."""
    if mesh is None or mesh.n_theta <= 1 or (
            mtip.shard is not None and mtip.shard.mesh is mesh):
        return mtip
    return mtip.theta_shard(mesh)


def _n_theta(mesh, batch):
    """The grid's θ rows of a whole batch on a θ axis, else None."""
    return int(batch.shape[-2]) if mesh is not None and mesh.n_theta > 1 \
        else None


class MultiStartRunner:
    """Multi-start phasing of one schedule: the restarts are the batch; on
    a rank's mesh, this rank's rows of it (on a θ axis the MTIP's θ shard
    on the rank's θ rows)."""

    def __init__(self, mtip, schedule, mesh=None):
        self.mtip = mtip = _rank_mtip(mtip, mesh)
        self.schedule = schedule
        self.mesh = mesh
        self.rank_launches = None
        self._launches0 = launch_counts(mtip)
        mtip.register_schedule_dynamics(schedule)

    def __call__(self, rho0_batch):
        """rho0_batch: the whole batch on the whole grid. → (state, errors
        (n_restarts, n_iter, error columns)), the best materialised;
        run_batch sets replay's schedule tables. On a rank's mesh: rank 0
        gets the whole batch's on the whole grid (and every rank's launch
        counts since the runner was made in rank_launches), the others
        (None, None)."""
        if self.mesh is None:
            return self.mtip.run_batch(rho0_batch, self.schedule)
        n = int(rho0_batch.shape[0])
        state, errors = self.mtip.run_batch(self.mesh.local(rho0_batch),
                                            self.schedule)
        state, errors, counts = self.mesh.gather_state(
            state, errors, n, _launches_since(self.mtip, self._launches0),
            n_theta=_n_theta(self.mesh, rho0_batch))
        self.rank_launches = counts
        return state, errors


def rank_restarts(states, errors=None):
    """Restart indices sorted by best error (ascending), and the best
    errors, on the host."""
    best = states.best_err.cpu().numpy()
    return np.argsort(best), best


def split_schedule_chunks(schedule):
    """Split a flattened schedule at shrink-wrap boundaries: each chunk is a
    run of segments ending with (and including) the next SW."""
    chunks, current = [], []
    for seg in schedule:
        current.append(seg)
        if seg.method in ("SW", "SW_center"):
            chunks.append(current)
            current = []
    if current:
        chunks.append(current)
    return chunks


def _chunk_structure_args(chunk, np_real=np.float32):
    """(structure, args) of a chunk for MTIP.run_chunk: ('SW',) with
    (σ, threshold), a marker with (), or (method, n, ft_stab[, delay]) with
    its β array; the numbers at `np_real`, the MTIP's real dtype, so that a
    float64 run in chunks equals one uninterrupted run."""
    structure, args = [], []
    for seg in chunk:
        if seg.method in ("SW", "SW_center"):
            structure.append((seg.method,))
            args.append((np_real(seg.sigma), np_real(seg.threshold)))
        elif seg.method in ("SNAPSHOT", "RESET_TO_BEST"):
            structure.append((seg.method,))
            args.append(())
        else:
            link = int(getattr(seg, "ft_stab_link_delay", 0) or 0)
            structure.append((seg.method, int(seg.n), bool(seg.ft_stab))
                             if not link else
                             (seg.method, int(seg.n), bool(seg.ft_stab),
                              link))
            args.append(np.asarray(seg.betas, dtype=np_real))
    return tuple(structure), tuple(args)


def _split_complex(data):
    """Complex arrays as `<name>_re` and `<name>_im` (the JAX package's
    checkpoint layout); other entries as they are."""
    out = {}
    for k, v in data.items():
        if np.iscomplexobj(v):
            out[k + "_re"], out[k + "_im"] = np.real(v), np.imag(v)
        else:
            out[k] = v
    return out


def _join_complex(data):
    """The inverse of _split_complex: each `<name>_re`, `<name>_im` pair as
    one complex array of the parts' precision."""
    out = {}
    for k, v in data.items():
        name = k[:-3]
        if k[-3:] in ("_re", "_im") and {name + "_re", name + "_im"} \
                <= data.keys():
            if k.endswith("_re"):
                re, im = np.asarray(v), np.asarray(data[name + "_im"])
                out[name] = (re + 1j * im).astype(
                    np.result_type(re.dtype, np.complex64))
        else:
            out[k] = v
    return out


class CheckpointingRunner:
    """Multi-start runner that executes the schedule in shrink-wrap-bounded
    chunks and, with a checkpoint_path, saves the batched PhasingState after
    every save_every-th chunk and after the last chunk of a call. On a
    rank's mesh each rank runs its rows (on a θ axis the MTIP's θ shard
    on its θ rows); rank 0 gathers the states for each save and writes the
    whole batch on the whole grid, the one-card layout, so that a
    checkpoint written under any mesh resumes under any other or on one
    card; every rank reads it and takes its rows."""

    def __init__(self, mtip, schedule, checkpoint_path: str | None = None,
                 save_every: int = 1, mesh=None):
        self.mtip = mtip = _rank_mtip(mtip, mesh)
        self.chunks = split_schedule_chunks(schedule)
        mtip.register_schedule_dynamics(schedule)
        if mtip.best_mode == "replay":
            mtip.set_schedule_tables(schedule)
        # each chunk's global iteration index, for replay's anchors
        self._chunk_pos = np.cumsum(
            [0] + [sum(s.n for s in c if s.method not in _MARKERS)
                   for c in self.chunks])[:-1]
        self.checkpoint_path = checkpoint_path
        self.save_every = max(int(save_every), 1)
        self.mesh = mesh
        self.rank_launches = None
        self._launches0 = launch_counts(mtip)

    # --------------------------------------------------------- checkpoint IO
    def _hdf5(self):
        return os.path.splitext(self.checkpoint_path)[1] == ".h5"

    def _save(self, state, errors_list, chunk_index, n=None, n_theta=None):
        """Write the state of the first n restarts (default all; on a mesh,
        gathered to rank 0, which alone writes; on a θ axis joined to the
        n_theta-row grid)."""
        data = state_arrays(state)
        data["errors"] = torch.cat(errors_list, dim=1).cpu().numpy()
        if self.mesh is not None:
            data = self.mesh.gather({k: np.array(v) for k, v in data.items()},
                                    name="checkpoint", n_theta=n_theta)
            if data is None:
                return
        data = {k: v[:n] for k, v in data.items()}
        data["chunk_index"] = np.int64(chunk_index)
        tmp = self.checkpoint_path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(tmp)), exist_ok=True)
        if self._hdf5():
            hdf5.save(tmp, _split_complex(data))
        else:
            with open(tmp, "wb") as f:
                np.savez(f, **data)
        os.replace(tmp, self.checkpoint_path)

    def _load(self):
        """→ (state or None, next chunk index, [errors so far]); on a mesh
        this rank's rows (and θ rows of the grid fields)."""
        if not (self.checkpoint_path
                and os.path.exists(self.checkpoint_path)):
            return None, 0, []
        if self._hdf5():
            fields = _join_complex(hdf5.load(self.checkpoint_path))
        else:
            with np.load(self.checkpoint_path, allow_pickle=False) as d:
                fields = {k: d[k] for k in d.files}
        chunk_index = int(fields.pop("chunk_index"))
        if self.mesh is not None:
            fields = {k: self.mesh.local(v, theta=k in GRID_FIELDS)
                      for k, v in fields.items()}
        prev = fields.pop("errors")
        state = state_from_numpy(device=self.mtip.device, **fields)
        if state.anchor_rho is None and self.mtip.best_mode == "replay":
            # a checkpoint written by eager bookkeeping, resumed under
            # replay: fresh anchors at the checkpointed best; the replayed
            # best is then the best found after the resume, held against
            # the checkpointed one by the ordinary best_err comparison
            state = state._replace(**self.mtip._anchor_fields(
                state.best_rho, state.best_mask))
        errors = [torch.as_tensor(prev, device=self.mtip.device)] \
            if prev.shape[1] > 0 else []
        return state, chunk_index, errors

    # ------------------------------------------------------------------ run
    def __call__(self, rho0_batch, resume=True, max_chunks=None):
        """Run the chunks from the checkpoint (resume) or from rho0_batch.
        max_chunks limits how many chunks this call runs; the checkpoint
        still lands, so a later call resumes where this one stopped. The
        replayed best is materialised once the last chunk has run.
        → (state, errors (n_restarts, n_iter so far, error columns)); on a
        rank's mesh rank 0 gets the whole batch's (and every rank's launch
        counts in rank_launches), the others (None, None)."""
        mtip, mesh = self.mtip, self.mesh
        n = int(rho0_batch.shape[0])
        n_theta = _n_theta(mesh, rho0_batch)
        state, start, errors = None, 0, []
        if resume and self.checkpoint_path:
            state, start, errors = self._load()
        if state is None:
            state, start, errors = mtip.initial_state_batch(
                rho0_batch if mesh is None else mesh.local(rho0_batch)), \
                0, []
        stop = len(self.chunks) if max_chunks is None \
            else min(start + int(max_chunks), len(self.chunks))
        for i in range(start, stop):
            structure, args = _chunk_structure_args(self.chunks[i],
                                                    mtip._np_real)
            state, errs = mtip.run_chunk(state, structure, args,
                                         pos0=int(self._chunk_pos[i]))
            errors.append(errs)
            if self.checkpoint_path and ((i + 1) % self.save_every == 0
                                         or i == stop - 1):
                self._save(state, errors, i + 1, n, n_theta)
        if stop == len(self.chunks):
            state = mtip.materialize_best(state)
        all_errors = torch.cat(errors, dim=1) if errors else torch.zeros(
            (state.rho.shape[0], 0, mtip._err_cols), dtype=mtip.rdtype,
            device=mtip.device)
        if mesh is None:
            return state, all_errors
        state, all_errors, self.rank_launches = mesh.gather_state(
            state, all_errors, n, _launches_since(mtip, self._launches0),
            n_theta=n_theta)
        return state, all_errors
