"""The systems under test, one class a kind of grid: the program's engine
built on the benchmark's inputs, driven one Lambda iteration at a time
through the engine's own run(), and the plain reference that checks an
iteration of it.

A configuration file names its kind ("grid": "regular" or "voronoi"),
its sizes and physics; a traffic file adds the engine's settings (its
Config fields: the iteration path, the wavelength chunk, the sweep
order).  Nothing here depends on a particular cell.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import time
from pathlib import Path

import torch

from . import data, work
from .reference import physics as ph
from .reference import regular as ref_regular
from .reference import voronoi as ref_voronoi

# the program's and the reference's caches of a Voronoi grid's host
# set-up, at a fixed place inside the checkout
CACHE = Path(__file__).resolve().parent.parent / "build" / "benchmark-cache" \
    / "voronoi"
# the keys of a configuration's "physics" that are Config fields
PHYSICS_KEYS = ("nlam_bb", "nlam_bf", "quadrature", "n_sweeps", "boost",
                "gamma_natural", "formal_interpolation", "upwind_exponent",
                "voronoi_order", "dtype")


def _quiet():
    """The engines print each iteration's criterion; the benchmark's
    standard output ends with its result."""
    return contextlib.redirect_stdout(io.StringIO())


def max_rel(got, want):
    """max |got - want| / |want| (absolute where want is 0), as a float."""
    got, want = got.double(), want.double()
    denom = torch.where(want == 0.0, 1.0, want.abs())
    return float((torch.abs(got - want) / denom).max())


class System:
    """What both kinds share: the Config from the configuration and the
    traffic, the iteration through run(), the host copy of the state and
    the reference's comparison."""

    def __init__(self, config, traffic, seed, device, dtype=None):
        from voronoirt_tpu_torch import Config
        self.config = config
        self.device = torch.device(device)
        kw = {k: v for k, v in config["physics"].items()
              if k in PHYSICS_KEYS}
        kw["compat"] = config["compat"]
        kw.update(traffic.get("engine", {}))
        if dtype is not None:
            kw["dtype"] = dtype
        self.cfg = Config(maxiter=1, eps=0.0, **kw)
        self.spans = {}
        self.state = None

    def step(self):
        """One Lambda iteration from the current state through the
        engine's run(), which ends in its criterion's readback; returns
        the criterion."""
        eng = self.engine
        if self.state is not None:
            eng.S_start, eng.populations_start = self.state
        with _quiet():
            res = eng.run()
        self.state = (res.S, res.populations)
        return float(res.convergence[-1])

    def counters_reset(self):
        """Zero the program's counters that per-layer metrics read."""

    def counters(self):
        return {}

    def host_state(self):
        """Copies of the state on the host (the engines update S in
        place)."""
        return tuple((t.clone() if t.device.type == "cpu" else t.cpu()
                      ).numpy() for t in self.state)

    def frozen(self):
        eng = self.engine
        out = {"lte": eng.lte, "a_cont": eng.a_cont, "eps": eng.eps}
        out.update({f"C_{i}{j}": v for (i, j), v in eng.C.items()})
        return out

    def free(self):
        """Drop the engine; the last state stays."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def line_ref(self):
        p = self.config["physics"]
        return ph.lyman_alpha(p["nlam_bb"], p["nlam_bf"])

    def quad_ref(self):
        return ph.quadrature(self.config["quadrature_rows"])

    def compare(self, frozen_prog, out, ref):
        """The numbers compared: the program's frozen fields, and S, the
        populations (relative) and the criterion (absolute: it is itself a
        relative change) of its checked iteration, out, against the
        reference's (ref: (frozen, S, pops, diff))."""
        r_frozen, r_S, r_pops, r_diff = ref
        want = {"lte": r_frozen.lte, "a_cont": r_frozen.a_cont,
                "eps": r_frozen.eps}
        want.update({f"C_{i}{j}": v for (i, j), v in r_frozen.C.items()})
        frozen = max(max_rel(frozen_prog[k].to(self.device), v)
                     for k, v in want.items())
        S, pops, diff = out
        return {"frozen_rel": frozen,
                "S_rel": max_rel(S.to(r_S.device), r_S),
                "pops_rel": max_rel(pops.to(r_pops.device), r_pops),
                "diff_abs": abs(diff - r_diff)}


class RegularSystem(System):
    """The regular grid: RegularEngine on a synthetic atmosphere made
    from the seed."""

    def __init__(self, config, traffic, seed, device, dtype=None):
        super().__init__(config, traffic, seed, device, dtype)
        from voronoirt_tpu_torch import Atmosphere
        from voronoirt_tpu_torch.engine import RegularEngine
        from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
        g = config["grid"]
        t = time.perf_counter()
        self.atmos = data.synthetic_atmosphere(g["nz"], g["nx"], g["ny"],
                                               seed)
        self.spans["data_s"] = time.perf_counter() - t
        atmos = Atmosphere(**self.atmos)
        T = torch.as_tensor(atmos.temperature, dtype=torch.float64,
                            device=self.device).to(
                                getattr(torch, self.cfg.dtype))
        line = lyman_alpha_line(self.cfg.nlam_bb, self.cfg.nlam_bf, T)
        import warnings
        with warnings.catch_warnings():
            # the synthetic n_e's charge-consistency warning
            warnings.simplefilter("ignore")
            self.engine = RegularEngine(atmos, line, self.cfg,
                                        device=self.device)

    def layers(self, rec):
        """Wrap the regular iteration's layer entry points."""
        from voronoirt_tpu_torch.engine import lambda_iter, s_update
        from voronoirt_tpu_torch.solvers import sweep_regular as sr
        ns = self.cfg.n_sweeps

        def esize(t):
            return t.element_size()

        rec.wrap(sr, "march_plane", "march_plane",
                 lambda a_p, *args, **kw: ("k2", work.march_plane(
                     *a_p.shape, kw["n_sweeps"], esize(a_p)), a_p.dtype))
        rec.wrap(sr, "xy_segment", "xy_segment",
                 lambda alpha, S, I0, steps, *args: ("k1", work.xy_segment(
                     len(steps), *I0.shape, esize(I0)), I0.dtype))
        rec.wrap(sr, "group_emit", "group_emit",
                 lambda planes, steps, w, *args: ("g1", work.group_emit(
                     planes.shape[0], w.shape[0],
                     planes.shape[1] // w.shape[0], *planes.shape[2:],
                     esize(planes)), planes.dtype))

        def stack(tensors, flips):
            distinct = {t.data_ptr(): t.numel() for t in tensors}
            return ("g2", work.group_stack(
                sum(distinct.values()), sum(t.numel() for t in tensors),
                esize(tensors[0])), tensors[0].dtype)
        rec.wrap(sr, "group_stack", "group_emit", stack)
        rec.wrap(sr, "group_fold", "group_emit",
                 lambda out, J_up, J_dn: ("g3", work.group_fold(
                     J_up.shape[1], *J_up.shape[2:], J_up.shape[0],
                     esize(J_up)), J_up.dtype))
        rec.wrap(lambda_iter, "alpha_tot_group", "extinction",
                 lambda line, lam_c, v, ks, flips, pops, a_cont=None,
                 g_cell=None, damp=None: (
                     "e1", ("alpha_tot_group", lam_c, tuple(map(tuple, ks)),
                            damp is not None), lam_c.dtype))
        rec.wrap(lambda_iter, "calculate_R_chunk", "rates",
                 lambda line, acc, J_blk, r0, *a, lead=None, **k: (
                     "r1", (r0, J_blk.shape[0] + (lead is not None),
                            frozenset(acc or {})), J_blk.dtype))
        rec.wrap(s_update, "s_update_stream", "rates",
                 lambda S, Jc, eps, T, lam_c, start: ("s1", work.s_update(
                     T.numel(), Jc.shape[0], esize(S)), S.dtype))
        return {"march_plane": r"march_(coeffs|chain)_kernel",
                "xy_segment": r"xy_segment_",
                "group_emit": r"group_(emit|stack|fold)_kernel",
                "extinction": r"alpha_tot_kernel",
                "rates": r"(rates_chunk|s_update)_kernel"}

    def reference(self, start):
        """The reference's frozen set-up and its iteration from the host
        state `start`: (frozen, S_new, pops_new, diff)."""
        grid = ref_regular.Grid(self.atmos, self.device)
        line = self.line_ref()
        frozen = ph.frozen_setup(line, grid.T, grid.ne, grid.nH,
                                 self.cfg.boost)
        S = torch.as_tensor(start[0], device=self.device).double()
        pops = torch.as_tensor(start[1], device=self.device).double()
        S_new, pops_new, diff = ref_regular.iterate(
            grid, line, frozen, S, pops, self.quad_ref(),
            n_sweeps=self.cfg.n_sweeps,
            gamma_natural=self.cfg.gamma_natural,
            max_group=self.cfg.group_max_angles, compat=self.cfg.compat)
        return frozen, S_new, pops_new, float(diff)

    def cells(self):
        return self.engine.T.numel()

    def work_fields(self, pops):
        """What the data-dependent counts read (Voigt regions): the
        damping rate at these populations, the Doppler width, the
        velocity and the line, on the device in float64."""
        grid = ref_regular.Grid(self.atmos, self.device)
        line = self.line_ref()
        pops = pops.to(self.device).double()
        g = ph.damping_rate(line, grid.T, pops[..., 0] + pops[..., 1],
                            grid.ne, self.cfg.gamma_natural)
        return {"line": line, "g": g, "dlamD": ph.doppler_width(line, grid.T),
                "v": grid.v}


class VoronoiSystem(System):
    """A Voronoi grid: VoronoiEngine on sites sampled from the
    configuration's fixed atmosphere and seed, carrying the fields of the
    atmosphere made from --seed.  The program's tessellation and plans
    come from its disk cache (Config.cache_dir) after a checkout's first
    run; so do the reference's neighbours."""

    def __init__(self, config, traffic, seed, device, dtype=None):
        super().__init__(config, traffic, seed, device, dtype)
        from voronoirt_tpu_torch import get_quadrature
        from voronoirt_tpu_torch.engine import VoronoiEngine
        from voronoirt_tpu_torch.grid import build_sites
        from voronoirt_tpu_torch.physics.atom import lyman_alpha_line
        self.cfg = dataclasses.replace(self.cfg, cache_dir=str(CACHE))
        g = config["grid"]
        src = g["sampled_from"]
        t = time.perf_counter()
        fixed = data.synthetic_atmosphere(src["nz"], src["nx"], src["ny"],
                                          src["seed"])
        self.pos, self.bounds = data.sample_sites(
            fixed, g["n_sites"], g["density"], g["site_seed"])
        a = config["atmosphere"]
        self.fields = data.site_fields(self.pos, data.synthetic_atmosphere(
            a["nz"], a["nx"], a["ny"], seed))
        self.spans["data_s"] = time.perf_counter() - t
        import warnings
        t = time.perf_counter()
        with warnings.catch_warnings():
            # 'layer' order at grazing angles; the synthetic n_e
            warnings.simplefilter("ignore")
            sites = build_sites(self.pos, self.bounds, self.fields,
                                cache_dir=self.cfg.cache_dir)
            plans = VoronoiEngine.build_plans(
                sites, get_quadrature(self.cfg.quadrature), self.cfg)
            self.spans["grid_s"] = time.perf_counter() - t
            T = torch.as_tensor(sites.temperature, dtype=torch.float64,
                                device=self.device).to(
                                    getattr(torch, self.cfg.dtype))
            line = lyman_alpha_line(self.cfg.nlam_bb, self.cfg.nlam_bf, T)
            self.engine = VoronoiEngine(sites, line, self.cfg, plans=plans,
                                        device=self.device)

    def counters_reset(self):
        from voronoirt_tpu_torch.solvers import sweep_voronoi
        sweep_voronoi.LEVEL_STEPS = 0

    def counters(self):
        from voronoirt_tpu_torch.solvers import sweep_voronoi
        return {"level_steps": sweep_voronoi.LEVEL_STEPS}

    def layers(self, rec):
        """Wrap the Voronoi iteration's layer entry points."""
        from voronoirt_tpu_torch.engine import lambda_iter
        from voronoirt_tpu_torch.solvers import sweep_voronoi as sv
        rec.wrap(sv, "voronoi_stage", "voronoi_level",
                 lambda I, sd, *a, **k: ("v1", (sd, I.shape[1],
                                                I.element_size()), I.dtype))
        # the direction is known where the engine asks for its
        # extinction; the span is around the extinction's call
        rec.wrap(self.engine, "_alpha_tot_T", "extinction",
                 lambda k, lam_c, populations, damp_c=None, *a, **kw: (
                     "e1", ("alpha_tot", lam_c, (tuple(k),),
                            damp_c is not None), lam_c.dtype),
                 span=False)
        rec.wrap(lambda_iter, "alpha_tot", "extinction")
        rec.wrap(lambda_iter, "calculate_R_chunk", "rates",
                 lambda line, acc, J_blk, r0, *a, lead=None, **k: (
                     "r1", (r0, J_blk.shape[0] + (lead is not None),
                            frozenset(acc or {})), J_blk.dtype))
        return {"voronoi_level": r"voronoi_stage_kernel",
                "extinction": r"alpha_tot_kernel",
                "rates": r"(rates_chunk|s_update)_kernel"}

    def _sites(self):
        return ref_voronoi.Sites(self.pos, self.bounds, self.fields,
                                 self.device, CACHE)

    def reference(self, start):
        sites = self._sites()
        line = self.line_ref()
        frozen = ph.frozen_setup(line, sites.T, sites.ne, sites.nH,
                                 self.cfg.boost)
        quad = self.quad_ref()
        plans = [ref_voronoi.plan(sites, quad[0][i], bool(quad[2][i]),
                                  self.cfg.upwind_exponent)
                 for i in range(len(quad[1]))]
        S = torch.as_tensor(start[0], device=self.device).double()
        pops = torch.as_tensor(start[1], device=self.device).double()
        S_new, pops_new, diff = ref_voronoi.iterate(
            sites, line, frozen, S, pops, quad, plans,
            n_sweeps=self.cfg.n_sweeps, gamma_natural=self.cfg.gamma_natural,
            compat=self.cfg.compat)
        return frozen, S_new, pops_new, float(diff)

    def work_fields(self, pops):
        line = self.line_ref()
        f = {k: torch.as_tensor(v, dtype=torch.float64, device=self.device)
             for k, v in self.fields.items()}
        pops = pops.to(self.device).double()
        v = torch.stack([f["velocity_z"], f["velocity_x"], f["velocity_y"]],
                        -1)
        return {"line": line, "v": v,
                "dlamD": ph.doppler_width(line, f["temperature"]),
                "g": ph.damping_rate(line, f["temperature"],
                                     pops[..., 0] + pops[..., 1],
                                     f["electron_density"],
                                     self.cfg.gamma_natural)}


SYSTEMS = {"regular": RegularSystem, "voronoi": VoronoiSystem}


def data_work(kind, key, fields, esize):
    """(bytes, ops) of a call whose counts read the data: an extinction
    ('e1') or rates ('r1') call, on `fields` (System.work_fields)."""
    line, g, dlamD = fields["line"], fields["g"], fields["dlamD"]
    lam_all = torch.as_tensor(line.lam, dtype=torch.float64,
                              device=g.device)
    if kind == "e1":
        name, lam_c, ks, rows = key
        lam = torch.as_tensor(lam_c, dtype=torch.float64, device=g.device)
        v_loses = [(fields["v"] * torch.as_tensor(
            [-c for c in k], dtype=torch.float64, device=g.device)).sum(-1)
            for k in ks]
        return work.extinction(name, lam, line.lam0, g, dlamD, v_loses,
                               esize, rows)
    r0, n_rows, acc = key
    return work.rates_chunk(lam_all, line.lam_idx, line.lam0, r0, n_rows,
                            acc, g, dlamD, esize)
