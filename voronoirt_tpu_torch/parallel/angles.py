"""Angle (quadrature) parallelism: distribute per-angle pipelines.

Port of voronoirt_tpu/parallel/angles.py.  Every direction has its own
sweep schedule (solvers/sweep_regular.build_plan), so the angle axis is
MPMD: the quadrature angles are dealt round-robin over a list of devices,
each angle's pipeline (line-of-sight Voigt profile -> extinction ->
formal solution -> weighted accumulate) runs on its owning device (CUDA
launches do not block the host, so distinct cards compute concurrently),
and the per-device partial J tensors are summed on the device that holds
S -- the reduction the serial loop performs implicitly.

Single process; `devices` is a sequence of torch.device (or their
strings).  The static copies, the broadcast state and the partial sums
are keyed by the SLOT index in `devices`, not by the device: a list that
names one device several times (["cpu"] * 3, or one card twice) still
gives that many partial sums, reduced at the end.  Tensor.to() onto a
tensor's own device returns the tensor itself, so such a list copies
nothing.

Usage:
    eng = RegularEngine(atmos, line, cfg)
    distribute_angles(eng, ["cuda:0", "cuda:1"])
    eng.run()          # compute_J now deals the angles over two cards
"""

from __future__ import annotations

import dataclasses

import torch


def distribute_angles(engine, devices):
    """Assign the engine's quadrature angles round-robin to `devices`.

    Places the per-run static per-angle inputs (velocities, continuum
    extinction, boundary temperature, the line with its Doppler widths)
    on every participating device; the per-iteration state (S,
    populations, damping) is broadcast by compute_J each iteration.
    """
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("distribute_angles needs at least one device")
    if (getattr(engine, "lam_group", None) is not None
            or getattr(engine, "mesh", None) is not None):
        # alternatives on the same devices (voronoirt_tpu/parallel/
        # angles.py:21-25)
        raise ValueError("an engine takes a lambda group or mesh "
                         "(parallel/lam.py, parallel/mesh.py) or angle "
                         "distribution, not both")
    static = []
    for d in devices:
        st = {"v": engine.v.to(d), "a_cont": engine.a_cont.to(d),
              "line": dataclasses.replace(engine.line,
                                          dlamD=engine.line.dlamD.to(d))}
        if hasattr(engine, "atmos"):           # regular grid
            st["T_bottom"] = engine.T[0].to(d)
        else:                                  # voronoi grid
            st["T"] = engine.T.to(d)
        static.append(st)
    engine.angle_devices = devices
    engine._angle_static = static
    return engine


def angle_device(engine, i):
    """Slot in engine.angle_devices that owns quadrature angle i
    (round-robin)."""
    return i % len(engine.angle_devices)


def broadcast_state(devices, **tensors):
    """Replicate per-iteration tensors onto every angle device: one dict
    per slot of `devices` (None values stay None)."""
    return [{k: (v if v is None else v.to(d)) for k, v in tensors.items()}
            for d in devices]


def partial_accumulate(partials, slot, value):
    """Accumulate a weighted sweep result into a slot's partial J, in
    place (the first value of a slot becomes its buffer)."""
    if slot in partials:
        partials[slot].add_(value)
    else:
        partials[slot] = value


def reduce_partials(partials, target):
    """Sum the per-slot partial J tensors on the target device: the
    explicit counterpart of the sum the serial loop performs implicitly;
    len(partials) <= len(devices) tensors move once."""
    total = None
    for slot in sorted(partials):
        p = partials[slot].to(target)
        total = p if total is None else total.add_(p)
    return total


def target_device(reference):
    """Device holding a reference tensor, for placing J."""
    return reference.device
