"""Multi-start runners for MTIP phasing on one card.

Port of `xframe_tpu.parallel.mesh` without the device mesh: restarts are
the leading batch axis of one MTIP run. `MultiStartRunner` runs a whole
schedule; `CheckpointingRunner` runs it in chunks that end at shrink-wrap
boundaries and writes the batched PhasingState to disk between chunks, so
that a later call resumes where an earlier one stopped. `rank_restarts`
orders the restarts by their best error.

A checkpoint holds host copies of the state's fields
(`convert.state_arrays`: the replay anchors and the linked ft-stab history
among them), the index of the next chunk and the errors so far. A path
ending in `.h5` gives the JAX package's HDF5 checkpoint (complex fields as
`<name>_re` and `<name>_im`; a JAX checkpoint resumes here), any other a
numpy `.npz` archive; it is written to `<path>.tmp` and then
moved over `<path>`, so a reader never finds half a file.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from xframe_tpu_torch.convert import state_arrays, state_from_numpy
from xframe_tpu_torch.io import hdf5

_MARKERS = ("SW", "SW_center", "SNAPSHOT", "RESET_TO_BEST")


class MultiStartRunner:
    """Multi-start phasing of one schedule: the restarts are the batch."""

    def __init__(self, mtip, schedule):
        self.mtip = mtip
        self.schedule = schedule
        mtip.register_schedule_dynamics(schedule)

    def __call__(self, rho0_batch):
        """→ (state, errors (n_restarts, n_iter, error columns)), the
        best materialised; run_batch sets replay's schedule tables."""
        return self.mtip.run_batch(rho0_batch, self.schedule)


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
    every save_every-th chunk and after the last chunk of a call."""

    def __init__(self, mtip, schedule, checkpoint_path: str | None = None,
                 save_every: int = 1):
        self.mtip = mtip
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

    # --------------------------------------------------------- checkpoint IO
    def _hdf5(self):
        return os.path.splitext(self.checkpoint_path)[1] == ".h5"

    def _save(self, state, errors_list, chunk_index):
        data = state_arrays(state)
        data["chunk_index"] = np.int64(chunk_index)
        data["errors"] = torch.cat(errors_list, dim=1).cpu().numpy()
        tmp = self.checkpoint_path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(tmp)), exist_ok=True)
        if self._hdf5():
            hdf5.save(tmp, _split_complex(data))
        else:
            with open(tmp, "wb") as f:
                np.savez(f, **data)
        os.replace(tmp, self.checkpoint_path)

    def _load(self):
        """→ (state or None, next chunk index, [errors so far])."""
        if not (self.checkpoint_path
                and os.path.exists(self.checkpoint_path)):
            return None, 0, []
        if self._hdf5():
            fields = _join_complex(hdf5.load(self.checkpoint_path))
        else:
            with np.load(self.checkpoint_path, allow_pickle=False) as d:
                fields = {k: d[k] for k in d.files}
        chunk_index = int(fields.pop("chunk_index"))
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
        → (state, errors (n_restarts, n_iter so far, error columns))."""
        mtip = self.mtip
        state, start, errors = None, 0, []
        if resume and self.checkpoint_path:
            state, start, errors = self._load()
        if state is None:
            state, start, errors = mtip.initial_state_batch(rho0_batch), 0, []
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
                self._save(state, errors, i + 1)
        if stop == len(self.chunks):
            state = mtip.materialize_best(state)
        all_errors = torch.cat(errors, dim=1) if errors else torch.zeros(
            (len(rho0_batch), 0, mtip._err_cols), dtype=mtip.rdtype,
            device=mtip.device)
        return state, all_errors
