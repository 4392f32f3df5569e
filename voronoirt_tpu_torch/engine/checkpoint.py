"""HDF5 checkpoint store + elastic resume.

Port of voronoirt_tpu/engine/checkpoint.py (reference src/io.jl
create_output_file :159-225, write_to_file :58-153, and
src/recover_simulation.jl :4-206): the output file IS the checkpoint --
populations + source function are overwritten in place every iteration
and a `convergence` dataset takes one scalar per iteration; a killed run
resumes by scanning `convergence` for the first zero and re-deriving all
frozen state from the inputs.

Same dataset names, shapes and units as the JAX package's files (and the
reference's), so either package reads the other's:
  regular: source_function (nlam,nz,nx,ny), populations (nz,nx,ny,3),
           z/x/y, the six scalar fields, convergence (maxiter+1),
           n_bb, n_bf, wavelength [nm], line_center [nm], time [s]
  voronoi: source_function (nlam,n), populations (n,3), positions (3,n),
           boundaries (6), ... same tail.
Units on disk: kW m^-2 nm^-1 (the native intensity unit) and SI m^-3.
The state datasets take the run's dtype (float32 for a float32 run);
everything else is float64.
write_state takes tensors on any device (or numpy arrays) and writes
numpy; h5py is imported inside the methods.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class CheckpointFile:
    """Writer/reader for the reference-schema HDF5 output."""

    def __init__(self, path):
        self.path = path

    # ------------------------------------------------------------ create

    def create_regular(self, line, atmos, maxiter, dtype="float64"):
        """A new file for a regular run; dtype ('float64' or 'float32',
        the run's Config.dtype) is the type of the source function and
        populations datasets (the JAX package writes float64 whatever
        the run's type)."""
        import h5py
        nlam = line.n_lambda
        nz, nx, ny = atmos.shape
        with h5py.File(self.path, "w") as f:
            f.create_dataset("source_function", (nlam, nz, nx, ny), dtype)
            f.create_dataset("populations", (nz, nx, ny, 3), dtype)
            f["z"] = np.asarray(atmos.z)
            f["x"] = np.asarray(atmos.x)
            f["y"] = np.asarray(atmos.y)
            for name, v in atmos.fields().items():
                f[name] = np.asarray(v)
            f["convergence"] = np.zeros(maxiter + 1)
            self._write_line(f, line)

    def create_voronoi(self, line, sites, maxiter, dtype="float64"):
        """A new file for a Voronoi run; dtype as in create_regular."""
        import h5py
        nlam = line.n_lambda
        n = sites.n
        with h5py.File(self.path, "w") as f:
            f.create_dataset("source_function", (nlam, n), dtype)
            f.create_dataset("populations", (n, 3), dtype)
            f["positions"] = sites.positions.T  # reference layout (3, n)
            for name in ("temperature", "electron_density",
                         "hydrogen_populations", "velocity_z",
                         "velocity_x", "velocity_y"):
                f[name] = np.asarray(getattr(sites, name))
            f["boundaries"] = np.asarray(sites.bounds)
            f["convergence"] = np.zeros(maxiter + 1)
            self._write_line(f, line)

    @staticmethod
    def _write_line(f, line):
        f["n_bb"] = np.array([line.lam_idx[1]])
        f["n_bf"] = np.array([line.lam_idx[2] - line.lam_idx[1]])
        f["wavelength"] = np.asarray(line.lam) * 1e9   # nm on disk
        f["line_center"] = np.array([line.lam0 * 1e9])
        f["time"] = np.zeros(1)

    # ------------------------------------------------------------- write

    def write_state(self, populations, S):
        import h5py
        with h5py.File(self.path, "r+") as f:
            f["source_function"][...] = _numpy(S)
            f["populations"][...] = _numpy(populations)

    def write_convergence(self, iteration, diff):
        import h5py
        with h5py.File(self.path, "r+") as f:
            conv = f["convergence"]
            if iteration < conv.shape[0]:
                conv[iteration] = diff

    def write_time(self, seconds):
        import h5py
        with h5py.File(self.path, "r+") as f:
            f["time"][0] = seconds

    # -------------------------------------------------------------- read

    def read_state(self):
        """(populations, source function, convergence) as numpy arrays."""
        import h5py
        with h5py.File(self.path, "r") as f:
            return (np.asarray(f["populations"]),
                    np.asarray(f["source_function"]),
                    np.asarray(f["convergence"]))

    def resume_iteration(self):
        """First unwritten convergence slot - 1 (recover_simulation.jl:46).

        Slot 0 is never written (the loop head writes slot i+1 starting
        at i=0, matching the reference's 1-based convergence[i+1]).
        """
        _, _, conv = self.read_state()
        zeros = np.nonzero(conv[1:] == 0.0)[0]
        nxt = int(zeros[0]) + 1 if len(zeros) else len(conv)
        return max(nxt - 1, 0)


def recover(engine, path):
    """Resume a Lambda iteration from a checkpoint.

    path: the HDF5 file's path, or a store with CheckpointFile's
    methods.  Mirrors recover_regular / recover_voronoi
    (recover_simulation.jl:4-206): all frozen state is re-derived by the
    engine constructor; populations and S come from the store, placed on
    the engine's device; the loop re-enters at the saved iteration.  It
    always re-enters the standard loop, so cfg.stream_rates does nothing
    on a resume, as in the JAX package.  On an engine split over ranks
    every rank reads the whole arrays and keeps its share; a store whose
    arrays do not cover the engine's whole line and grid is refused.
    """
    from .lambda_iter import _run_iteration
    ckpt = path if hasattr(path, "read_state") else CheckpointFile(path)
    pops, S, _ = ckpt.read_state()
    shape = engine.grid_shape()
    want = ((engine.line.n_lambda,) + shape, shape + (3,))
    got = tuple(None if a is None else tuple(a.shape) for a in (S, pops))
    if got != want:
        raise ValueError(f"the store's source function and populations "
                         f"are {got[0]} and {got[1]}; this engine's line "
                         f"and grid need {want[0]} and {want[1]}")
    it = ckpt.resume_iteration()
    return _run_iteration(engine, checkpoint=ckpt, start_iteration=it,
                          S_init=S, populations_init=pops)
