"""Plain reference of one Lambda iteration on the regular grid.

The short-characteristics formal solution of the published method
(src/characteristics.jl) with its documented quirks: per z-step the
plane cut with the shortest path (xy: the upwind point in the previous
plane, bilinear and periodic; yz / xz: the upwind point on a column of
the current plane, which the reference relaxes with n_sweeps passes of
a one-line buffer that starts at zero once, the upwind column at
ix + sign, and for originally-down rays in the xz case the centre
values read from the upper plane), the two-point linear update with
its Taylor guards, J over the quadrature, S = (1 - eps) J + eps B, the
radiative rates and the statistical equilibrium.

Mirror directions run together: each direction's fields are mirrored
so that it sweeps up and towards +x, +y, and the directions whose plane
cuts then coincide share one sweep with the wavelength axis.  Every
field is made plane by plane as the sweep reaches it, so the reference
holds S, J and a few planes.  Plain PyTorch, float64; it imports
nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import physics as ph


# ------------------------------------------------------------------ plans

def _loop_signs(k):
    if k[1] > 0 and k[2] > 0:
        return -1, -1
    if k[1] < 0 and k[2] > 0:
        return 1, -1
    if k[1] < 0 and k[2] < 0:
        return 1, 1
    if k[1] > 0 and k[2] < 0:
        return -1, 1
    return 1, 1


def plan(k, z, dx, dy):
    """The z-steps of an upward sweep along direction k over the
    ascending axis z: per step (case, plane, r, fx, fy, w_cur), and the
    march's statics."""
    k = np.asarray(k, dtype=np.float64)
    sign_x, sign_y = _loop_signs(k)
    r_x = abs(dx / k[1]) if k[1] != 0 else np.inf
    r_y = abs(dy / k[2]) if k[2] != 0 else np.inf
    sxs = 0 if k[1] >= 0 else -1
    sys_ = 0 if k[2] >= 0 else -1
    fy_line = float(np.clip(r_x * k[2] / dy - sys_, 0.0, 1.0)) \
        if np.isfinite(r_x) else 1.0
    fx_line = float(np.clip(r_y * k[1] / dx - sxs, 0.0, 1.0)) \
        if np.isfinite(r_y) else 1.0
    steps = []
    for i in range(1, len(z)):
        dz = z[i] - z[i - 1]
        r_z = abs(dz / k[0]) if k[0] != 0 else np.inf
        case = ("xy", "yz", "xz")[int(np.argmin([r_z, r_x, r_y]))]
        if case == "xy":
            r = r_z
            fx = np.clip(r * k[1] / dx - sxs, 0.0, 1.0) if np.isfinite(r) \
                else 1.0
            fy = np.clip(r * k[2] / dy - sys_, 0.0, 1.0) if np.isfinite(r) \
                else 1.0
            wc = 0.0
        else:
            r = r_x if case == "yz" else r_y
            fx = fy = 0.0
            wc = 1.0 - r * abs(k[0]) / dz
        steps.append((case, i, float(r), float(fx), float(fy), float(wc)))
    return dict(steps=steps, sign_x=sign_x, sign_y=sign_y, sxs=sxs,
                sys=sys_, r_x=float(r_x), r_y=float(r_y), fy_line=fy_line,
                fx_line=fx_line)


def mirror_groups(ks, ups, z, dx, dy, max_group=None):
    """Directions grouped by the plane cuts of their mirrored sweeps:
    [[(angle, plan, (flip_x, flip_y, flip_z)), ...], ...]."""
    z = np.asarray(z)
    zf = z[0] + (z[-1] - z[::-1])
    groups = {}
    for i, (k, up) in enumerate(zip(ks, ups)):
        flips = (bool(k[1] < 0), bool(k[2] < 0), not bool(up))
        kc = np.array([-abs(k[0]), abs(k[1]), abs(k[2])])
        p = plan(kc, zf if flips[2] else z, dx, dy)
        sig = (p["sign_x"], p["sign_y"], p["sxs"], p["sys"],
               tuple((s[0], s[1]) for s in p["steps"]))
        groups.setdefault(sig, []).append((i, p, flips))
    out = list(groups.values())
    if max_group:
        out = [g[j:j + max_group] for g in out
               for j in range(0, len(g), max_group)]
    return out


# ---------------------------------------------------------- formal update

def linear_weights(dtau):
    """(alpha, beta, exp(-dtau)) of I = e I_up + alpha S_up + beta S_c,
    with the Taylor guards below 5e-4 and above 50
    (src/functions.jl:484-500)."""
    d = torch.clamp(dtau, 5e-4, 50.0)
    ex = torch.exp(-d)
    a_mid = (1.0 - ex) / d - ex
    b_mid = 1.0 - a_mid - ex
    small, large = dtau < 5e-4, dtau > 50.0
    a_large = 1.0 / torch.clamp(dtau, min=1.0)
    alpha = torch.where(small, dtau * (0.5 - dtau / 3.0),
                        torch.where(large, a_large, a_mid))
    beta = torch.where(small, dtau * (0.5 - dtau / 6.0),
                       torch.where(large, 1.0 - a_large, b_mid))
    expdt = torch.where(small, 1.0 - dtau + 0.5 * dtau * dtau,
                        torch.where(large, 0.0, ex))
    return alpha, beta, expdt


def _bilinear(A, sxs, sys_, fx, fy):
    """A sampled at (x + sxs + fx, y + sys + fy), periodic, y first."""
    Ay = (1.0 - fy) * torch.roll(A, -sys_, -1) \
        + fy * torch.roll(A, -(sys_ + 1), -1)
    return (1.0 - fx) * torch.roll(Ay, -sxs, -2) \
        + fx * torch.roll(Ay, -(sxs + 1), -2)


def xy_step(a_p, a_c, s_p, s_c, I_p, r, fx, fy, sxs, sys_):
    a_up = _bilinear(a_p, sxs, sys_, fx, fy)
    aw, bw, ew = linear_weights(r * (a_c + a_up) * 0.5)
    return ew * _bilinear(I_p, sxs, sys_, fx, fy) \
        + aw * _bilinear(s_p, sxs, sys_, fx, fy) + bw * s_c


def march_step(a_p, a_c, s_p, s_c, I_p, r, f, w_cur, c_prev, axis, sign,
               s_base, n_sweeps):
    """A yz (axis 'x') or xz (axis 'y') plane: the point's upwind value
    on the column at ix + sign, interpolated along the line and in z
    between the previous plane and the line buffer, which n_sweeps passes
    over the columns relax."""
    col = (lambda A: A) if axis == "x" else (lambda A: A.transpose(-1, -2))
    N = a_c.shape[-2 if axis == "x" else -1]
    upwind = (torch.arange(N, device=a_c.device) + sign) % N

    def line(A):
        return (1.0 - f) * torch.roll(A, -s_base, -1) \
            + f * torch.roll(A, -(s_base + 1), -1)

    def up(A):
        return line(torch.index_select(col(A), 1, upwind))

    wp = 1.0 - w_cur
    a_c0 = col(c_prev * a_p + (1.0 - c_prev) * a_c)
    s_c0 = col(c_prev * s_p + (1.0 - c_prev) * s_c)
    aw, bw, ew = linear_weights(
        r * (a_c0 + wp * up(a_p) + w_cur * up(a_c)) * 0.5)
    const = ew * (wp * up(I_p)) + aw * (wp * up(s_p) + w_cur * up(s_c)) \
        + bw * s_c0
    coeff = ew * w_cur
    c_lo, c_hi = coeff * (1.0 - f), coeff * f
    if sign < 0:
        # the columns in the march's order
        c_lo, c_hi, const = (torch.flip(a, (1,)) for a in (c_lo, c_hi,
                                                           const))
    out = _relax(c_lo, c_hi, const, s_base, n_sweeps)
    return col(torch.flip(out, (1,)) if sign < 0 else out)


def _relax_loop(c_lo, c_hi, const, out, s_base, n_sweeps):
    """The buffer relaxation, columns in order: buf = c_lo buf[y + s] +
    c_hi buf[y + s + 1] + const (the line interpolation times the
    coefficient), the buffer starting at zero once."""
    buf = const.new_zeros(const[:, 0].shape)
    for _ in range(n_sweeps):
        for c in range(const.shape[1]):
            lo = torch.roll(buf, -s_base, -1) if s_base else buf
            buf = torch.addcmul(const[:, c], c_lo[:, c], lo)
            buf.addcmul_(c_hi[:, c], torch.roll(lo, -1, -1))
            out[:, c] = buf
    return out


_GRAPHS = {}


def _relax(c_lo, c_hi, const, s_base, n_sweeps):
    """_relax_loop; on the card replayed from a CUDA graph of the same
    operations, one a shape (the loop is ~3,000 small operations a
    plane, which the host would otherwise launch one by one)."""
    if not const.is_cuda:
        return _relax_loop(c_lo, c_hi, const, torch.empty_like(const),
                           s_base, n_sweeps)
    key = (tuple(const.shape), const.dtype, const.device, s_base, n_sweeps)
    if key not in _GRAPHS:
        ins = [torch.zeros_like(const) for _ in range(3)]
        out = torch.empty_like(const)
        side = torch.cuda.Stream(const.device)
        side.wait_stream(torch.cuda.current_stream(const.device))
        with torch.cuda.stream(side):
            _relax_loop(*ins, out, s_base, n_sweeps)
        torch.cuda.current_stream(const.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _relax_loop(*ins, out, s_base, n_sweeps)
        _GRAPHS[key] = (graph, ins, out)
    graph, ins, out = _GRAPHS[key]
    for dst, src in zip(ins, (c_lo, c_hi, const)):
        dst.copy_(src)
    graph.replay()
    return out.clone()


# --------------------------------------------------------------- iteration

class Grid:
    """The regular grid's fields on the device: T, n_e, n_H, the velocity
    (z, x, y last) and the axes."""

    def __init__(self, atmos, device):
        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=device)
        self.T = f(atmos["temperature"])
        self.ne = f(atmos["electron_density"])
        self.nH = f(atmos["hydrogen_populations"])
        self.v = torch.stack([f(atmos["velocity_z"]), f(atmos["velocity_x"]),
                              f(atmos["velocity_y"])], -1)
        self.z = np.asarray(atmos["z"], dtype=np.float64)
        self.dx = float(atmos["x"][1] - atmos["x"][0])
        self.dy = float(atmos["y"][1] - atmos["y"][0])


def _flip_xy(A, fx, fy):
    dims = [d for d, on in ((-2, fx), (-1, fy)) if on]
    return torch.flip(A, dims) if dims else A


def _group_J(grid, line, frozen, gamma, populations, S, J, quad, group,
             n_sweeps):
    """Add one mirror group's w-weighted intensities into J (nlam, nz,
    nx, ny), plane by plane."""
    k, w, _ = quad
    nz = grid.T.shape[0]
    lam = torch.as_tensor(line.lam, dtype=S.dtype, device=S.device)
    nl = lam.shape[0]
    P = len(group)
    lead = group[0][1]

    def per(vals):
        """(P,) per-direction values as (P*nlam, 1, 1)."""
        return torch.as_tensor(np.repeat(np.asarray(vals, np.float64), nl),
                               dtype=S.dtype, device=S.device)[:, None, None]

    def zp(t, fz):
        return nz - 1 - t if fz else t

    def fields(t):
        """The mirrored extinction and S of canonical plane t, (P*nlam,
        nx, ny)."""
        a, s = [], []
        for i, _, (fx, fy, fz) in group:
            z = zp(t, fz)
            v_los = (grid.v[z] * torch.as_tensor(-k[i], dtype=S.dtype,
                                                 device=S.device)).sum(-1)
            alpha = ph.extinction(line, lam, v_los, populations[z],
                                  _cut(frozen, z), gamma[z])
            a.append(_flip_xy(alpha, fx, fy))
            s.append(_flip_xy(S[:, z], fx, fy))
        return torch.cat(a), torch.cat(s)

    def emit(t, I):
        for e, (i, _, (fx, fy, fz)) in enumerate(group):
            J[:, zp(t, fz)].add_(_flip_xy(I[e * nl:(e + 1) * nl], fx, fy),
                                 alpha=float(w[i]))

    I0 = []
    for i, _, (fx, fy, fz) in group:
        if fz:
            I0.append(torch.zeros((nl,) + tuple(grid.T.shape[1:]),
                                  dtype=S.dtype, device=S.device))
        else:
            I0.append(_flip_xy(ph.planck(lam[:, None, None], grid.T[0][None]),
                               fx, fy))
    I = torch.cat(I0)
    emit(0, I)
    a_p, s_p = fields(0)
    for j, (case, t, _, _, _, _) in enumerate(lead["steps"]):
        a_c, s_c = fields(t)
        steps = [p["steps"][j] for _, p, _ in group]
        if case == "xy":
            I = xy_step(a_p, a_c, s_p, s_c, I, per([s[2] for s in steps]),
                        per([s[3] for s in steps]), per([s[4] for s in steps]),
                        lead["sxs"], lead["sys"])
        else:
            yz = case == "yz"
            c_prev = per([float(fz and not yz) for _, _, (_, _, fz) in group])
            pp = [p for _, p, _ in group]
            I = march_step(
                a_p, a_c, s_p, s_c, I,
                per([p["r_x"] if yz else p["r_y"] for p in pp]),
                per([p["fy_line"] if yz else p["fx_line"] for p in pp]),
                per([s[5] for s in steps]), c_prev, "x" if yz else "y",
                lead["sign_x"] if yz else lead["sign_y"],
                lead["sys"] if yz else lead["sxs"], n_sweeps)
        emit(t, I)
        a_p, s_p = a_c, s_c


def _cut(frozen, z):
    return ph.Frozen(lte=frozen.lte[z], a_cont=frozen.a_cont[z],
                     eps=frozen.eps[z], C=None, dlamD=frozen.dlamD[z])


def iterate(grid, line, frozen, S, populations, quad, n_sweeps=3,
            gamma_natural=4.702e8, max_group=None, compat="reference",
            slab=8):
    """One Lambda iteration from (S, populations): (S_new, populations_new,
    criterion).  S is left as it was."""
    gamma = ph.damping_rate(line, grid.T,
                            populations[..., 0] + populations[..., 1],
                            grid.ne, gamma_natural)
    J = torch.zeros_like(S)
    k, w, up = quad
    for group in mirror_groups(k, up, grid.z, grid.dx, grid.dy, max_group):
        _group_J(grid, line, frozen, gamma, populations, S, J, quad, group,
                 n_sweeps)
    nz = grid.T.shape[0]
    pops = torch.empty_like(populations)
    for z0 in range(0, nz, slab):
        cells = slice(z0, min(z0 + slab, nz))
        R = ph.radiative_rates(line, J, frozen, gamma, grid.T, compat, cells)
        pops[cells] = ph.statistical_equilibrium(
            R, {key: c[cells] for key, c in frozen.C.items()}, grid.nH[cells])
    lam = torch.as_tensor(line.lam, dtype=S.dtype, device=S.device)
    diff = torch.zeros((), dtype=S.dtype, device=S.device)
    for r in range(J.shape[0]):
        # J's row becomes S_new's row in place
        J[r].mul_(1.0 - frozen.eps).add_(
            frozen.eps * ph.planck(lam[r], grid.T))
        new = J[r]
        denom = torch.where(new != 0.0, new, 1.0)
        diff = torch.maximum(diff, (torch.abs(new - S[r]) / denom.abs()).max())
    return J, pops, diff
