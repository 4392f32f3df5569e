"""Wavelength parallelism across processes: one lambda block per rank.

The port's counterpart of the "lam" axis of voronoirt_tpu/parallel/mesh.py
(make_mesh, shard_regular, shard_voronoi).  JAX places an engine's arrays
on a device mesh and GSPMD emits the collectives; here each rank is one
process joined by torch.distributed (one card a rank over NCCL, or ranks
sharing a card, or the CPU, over gloo).  A rank owns one contiguous block
[lo, hi) of the (padded) wavelength grid through profile, extinction,
sweep, J and the S update, and the engine calls the collectives itself
(engine/lambda_iter.py):

  * the rate integrals, a sum over wavelength: each rank sums the
    trapezoid pairs inside its block, receives J's row lo - 1 from the
    rank before it for the pair across its lower edge, and the six rate
    tensors are all_reduced (SUM), so every rank solves the statistical
    equilibrium on the same inputs and holds the same populations;
  * the convergence criterion, all_reduced (MAX) with a NaN flag beside
    it, since a NaN under MAX is not defined alike across backends.

Only all_reduce and broadcast are used: gloo runs both on CUDA tensors
too, so one code path serves NCCL across cards and gloo with two ranks
on one card (NCCL refuses two ranks on one device).

The spatial axes -- "y" and "x" of the regular grid, "site" of the
Voronoi grid -- and make_hybrid_mesh are parallel/mesh.py's, whose
"lam" sub-group is a LamGroup of this module.  A lambda group and
parallel/angles.py's angle slots are alternatives on the same devices
(voronoirt_tpu/parallel/angles.py:21-25): an engine takes one or the
other.

Usage, in each of n processes (spawn() starts them from one):
    group = join_group(rank, n, "file:///tmp/rendezvous")
    line = pad_line(line, -(-line.n_lambda // n) * n)
    eng = RegularEngine(atmos, line, cfg, device=group.device,
                        lam_group=group)     # B0 for the block only
    res = eng.run()                          # res.S: this rank's block
    S = gather_lambda(res.S, group)          # the whole S, every rank
"""

from __future__ import annotations

import datetime
import os
import queue
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..device import require_cuda

# the six radiative-rate keys, in the order they travel in one all_reduce
_R_KEYS = ((0, 2), (2, 0), (1, 2), (2, 1), (0, 1), (1, 0))


class LamGroup:
    """One rank's place in a lambda group: its rank, the group size, the
    device its tensors live on and the torch.distributed backend.
    seconds, calls and bytes count the collectives this rank made (the
    bytes of the tensor each call was given), seconds on the host's
    clock with the device synchronised on both sides (so waiting for a
    slower rank counts).  pg and ranks: the torch.distributed sub-group
    and its members' global ranks in group order, for a group that is
    one axis of a mesh (parallel/mesh.py); by default the whole world."""

    def __init__(self, rank, size, device, backend, pg=None, ranks=None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.pg = pg
        self.ranks = list(ranks) if ranks is not None else list(range(size))
        self.seconds = 0.0
        self.calls = 0
        self.bytes = 0

    def block(self, n_lambda):
        """This rank's rows [lo, hi) of an n_lambda grid; the grid must
        split evenly (pad it with physics.atom.pad_line first)."""
        if n_lambda % self.size:
            raise ValueError(
                f"{n_lambda} wavelengths do not split over {self.size} "
                f"ranks: pad the line with physics.atom.pad_line to a "
                f"multiple of {self.size}")
        n = n_lambda // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def _run(self, collective, tensor, **kwargs):
        """collective(tensor) over this group; returns (tensor, its
        seconds)."""
        if self.pg is not None:
            kwargs["group"] = self.pg
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        t0 = time.perf_counter()
        collective(tensor, **kwargs)
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        dt = time.perf_counter() - t0
        self.seconds += dt
        self.calls += 1
        self.bytes += tensor.numel() * tensor.element_size()
        return tensor, dt


def _backend(backend, device, n_ranks):
    """The backend for n_ranks on `device`: NCCL (one card a rank) by
    default on a card, gloo on the CPU.  NCCL on the CPU, or with more
    ranks than visible cards, raises."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        if n_ranks > torch.cuda.device_count():
            raise RuntimeError(
                f"nccl with {n_ranks} ranks needs {n_ranks} visible cards, "
                f"have {torch.cuda.device_count()}: use backend='gloo' to "
                f"share a card")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}; have 'nccl', 'gloo'")
    return backend


def _rank_device(device, backend, rank):
    """NCCL: card `rank`; gloo: the given device for every rank (a card
    named without an index is card 0)."""
    if backend == "nccl":
        return torch.device("cuda", rank)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


def join_group(rank, world_size, init_method, backend=None, device=None,
               timeout=900.0):
    """Join (the first caller creates) the default torch.distributed
    process group as `rank` of `world_size`, and return this rank's
    LamGroup.  device: where the rank's tensors live (default: the CUDA
    card); backend: 'nccl' (the default on a card: card `rank`, one a
    rank) or 'gloo' (the default on the CPU; on a card every rank uses
    `device`).  init_method: a 'file://' or 'tcp://' rendezvous address;
    timeout: seconds a collective may wait for the other ranks."""
    device = torch.device(device) if device is not None else require_cuda()
    backend = _backend(backend, device, world_size)
    device = _rank_device(device, backend, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return LamGroup(rank, world_size, device, backend)


def leave_group():
    """Destroy the default process group (join_group's counterpart)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------- engines


def attach(engine, group):
    """Make `engine` own `group`'s block of its line (engine.lam_group,
    engine.lam_block); the engines call it before their frozen set-up."""
    if getattr(engine, "angle_devices", None):
        raise ValueError("an engine takes a lambda group or angle "
                         "distribution (parallel/angles.py), not both")
    if getattr(engine, "lam_group", None) is not None:
        raise ValueError("the engine already has a lambda group")
    engine.lam_block = group.block(engine.line.n_lambda)
    engine.lam_group = group


def shard_regular(engine, group):
    """Give an engine built whole `group`'s lambda block: its B0 (and a
    loaded S) keep the block's rows, and its J passes, rates and
    criterion run over the block with the group's collectives.  The
    names of JAX's mesh.py (shard_regular, shard_voronoi on a ("lam",)
    mesh; parallel/mesh.py has the same names for a whole mesh), one
    function for both engines, kept for code written against a lambda
    group: the whole B0
    has existed by then, which building the engine with lam_group=group
    avoids."""
    attach(engine, group)
    engine._cut_fields()      # the block's rows; the full cubes are freed
    return engine


shard_voronoi = shard_regular


# --------------------------------------------------------- collectives


def _broadcast(group, t, src):
    """Rank src's `t` on every rank (a fresh contiguous tensor shaped like
    the local `t`)."""
    buf = (t.contiguous().clone() if src == group.rank
           else torch.empty_like(t, memory_format=torch.contiguous_format))
    return group._run(dist.broadcast, buf, src=group.ranks[src])[0]


def gather_lambda(t, group):
    """The whole (n_lambda, ...) tensor on every rank from each rank's
    (block, ...) rows: one broadcast a rank (for a caller that wants the
    whole S; the iteration itself never gathers)."""
    return torch.cat([_broadcast(group, t, src) for src in range(group.size)])


def previous_row(group, last):
    """J's row lo - 1, the previous rank's last row (1, ...), which the
    trapezoid pair across this rank's lower block edge needs; None on
    rank 0 and without a group (None).  `last` is this rank's last row.
    One broadcast a rank but the last, each to every rank."""
    prev = None
    for src in range(group.size - 1 if group is not None else 0):
        buf = _broadcast(group, last, src)
        if src == group.rank - 1:
            prev = buf
    return prev


def all_reduce_rates(group, R, like):
    """Sum each radiative-rate tensor of {(i, j): tensor} over the ranks,
    in one all_reduce; a key this rank's block does not reach counts as
    zeros shaped like `like`.  Without a group (None), R as it is."""
    if group is None:
        return R
    flat = torch.stack([R[k] if k in R else torch.zeros_like(like)
                        for k in _R_KEYS])
    group._run(dist.all_reduce, flat, op=dist.ReduceOp.SUM)
    return {k: flat[i] for i, k in enumerate(_R_KEYS)}


def global_max(group, value):
    """The maximum over the ranks of a 0-d tensor, as a float; NaN when
    any rank's value is NaN (the flag travels beside the value).
    Without a group (None), the value itself."""
    if group is None:
        return float(value)
    v = torch.stack([torch.isnan(value).to(value.dtype),
                     torch.nan_to_num(value, nan=-torch.inf)])
    group._run(dist.all_reduce, v, op=dist.ReduceOp.MAX)
    return float("nan") if bool(v[0] > 0) else float(v[1])


# ---------------------------------------------------------------- spawn


def _rank_main(fn, rank, n_ranks, init_method, device, backend, args,
               results, threads):
    """One spawned rank: join the group, run fn(group, *args), report
    (rank, True, result) or (rank, False, traceback) on `results`."""
    try:
        if threads:
            torch.set_num_threads(threads)
        group = join_group(rank, n_ranks, init_method, backend=backend,
                           device=device)
        try:
            out = fn(group, *args)
        finally:
            leave_group()
        # the port's ranks, like the port, import nothing of JAX
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "voronoirt_tpu"))
        if bad:
            raise RuntimeError(f"rank {rank} imported {bad[:5]}")
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


def _collect(results, procs, timeout):
    """Each rank's result, in rank order.  Raises when a rank failed or
    died without reporting, naming every rank that did within 10 s of
    the first (a rank's failure often makes the others fail in their
    next collective), or when `timeout` seconds pass."""
    got, failed = {}, {}
    deadline = time.monotonic() + timeout
    while len(got) + len(failed) < len(procs):
        try:
            rank, ok, out = results.get(timeout=1.0)
        except queue.Empty:
            for r, p in enumerate(procs):
                if (r not in got and r not in failed and results.empty()
                        and p.exitcode not in (None, 0)):
                    failed[r] = f"exited with code {p.exitcode}"
            if time.monotonic() > deadline:
                break
            continue
        if ok:
            got[rank] = out
        else:
            failed[rank] = out
        if failed:
            deadline = min(deadline, time.monotonic() + 10.0)
    if failed:
        raise RuntimeError("\n".join(f"rank {r} failed: {failed[r]}"
                                     for r in sorted(failed)))
    if len(got) < len(procs):
        raise TimeoutError(f"ranks {sorted(set(range(len(procs))) - set(got))}"
                           f" gave no result in {timeout} s")
    return [got[r] for r in range(len(procs))]


def spawn(fn, n_ranks, args=(), device=None, backend=None, timeout=1800.0,
          threads=None):
    """Run fn(group, *args) in n_ranks new processes joined into one
    lambda group; returns their results in rank order.

    fn must be importable by name (a module-level function); results
    travel pickled, so return numpy arrays, not tensors.  device: the
    ranks' device (default: the CUDA card); backend as join_group.  The
    rendezvous is a file in a temporary directory, so no address or
    port is chosen; the ranks talk over the host's own interfaces.  A rank
    that fails, dies or outlives `timeout` seconds makes the call raise;
    every process started is stopped before it returns.  threads: torch
    threads a rank (CPU runs).
    """
    device = torch.device(device) if device is not None else require_cuda()
    backend = _backend(backend, device, n_ranks)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n_ranks, init, device, backend,
                                   args, results, threads))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        ok = False
        try:
            out = _collect(results, procs, timeout)
            ok = True
        finally:
            for p in procs:
                p.join(timeout=60 if ok else 5)
                if p.is_alive():
                    p.kill()
                    p.join()
    return out
