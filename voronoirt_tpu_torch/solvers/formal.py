"""Formal-solution quadrature weights.

Port of voronoirt_tpu/solvers/formal.py (reference src/functions.jl:
484-500 `linear_weights`, :392-395 `trapezoidal`).  The two-point linear
short-characteristics update is
  I = exp(-dtau) I_up + alpha * S_up + beta * S_centre,
with Taylor guards for small (dtau < 5e-4) and large (dtau > 50) optical
depths.  Branch selection is by torch.where, as in the JAX package; the
CUDA kernels (csrc/formal.cuh) branch per point on the same thresholds.
"""

import torch


def linear_weights(dtau):
    """(alpha, beta, exp(-dtau)) weights for the two-point formal solution.

    alpha weights S_upwind, beta weights S_centre.
    """
    # safe value for the generic branch (avoid 0/0 in unselected lanes)
    dt_safe = torch.clamp(dtau, 5e-4, 50.0)
    exp_mid = torch.exp(-dt_safe)
    alpha_mid = (1.0 - exp_mid) / dt_safe - exp_mid
    beta_mid = 1.0 - alpha_mid - exp_mid

    # dtau / 3 and dtau / 6 as true divisions on every device: PyTorch's
    # CUDA kernels divide by a Python scalar as a product with its
    # reciprocal, a rounding off the division that the kernels
    # (csrc/formal.cuh) and the reference make
    three, six = (torch.full((), v, dtype=dtau.dtype, device=dtau.device)
                  for v in (3.0, 6.0))
    exp_small = 1.0 - dtau + 0.5 * dtau * dtau
    alpha_small = dtau * (0.5 - dtau / three)
    beta_small = dtau * (0.5 - dtau / six)

    # the reference's large branch divides by the TRUE dtau
    # (functions.jl:491-493), not a clipped one
    alpha_large = 1.0 / torch.clamp(dtau, min=1.0)
    beta_large = 1.0 - alpha_large

    small = dtau < 5e-4
    large = dtau > 50.0
    alpha = torch.where(small, alpha_small,
                        torch.where(large, alpha_large, alpha_mid))
    beta = torch.where(small, beta_small,
                       torch.where(large, beta_large, beta_mid))
    expdt = torch.where(small, exp_small, torch.where(large, 0.0, exp_mid))
    return alpha, beta, expdt


def trapezoidal(dx, a, b):
    """Trapezoid: dx * (a + b) / 2 (src/functions.jl:392-395)."""
    return dx * (a + b) * 0.5


def bezier_weights(dtau):
    """Quadratic (DELO-)Bezier formal-solution weights.

    Same formulae and branch thresholds as the JAX package
    (de la Cruz Rodriguez & Piskunov 2013); csrc/formal.cuh branches per
    point on the same thresholds.  Returns (w_up, w_c, w_ctrl,
    exp(-dtau)).
    """
    dt = torch.clamp(dtau, 0.05, 50.0)     # safe lanes for the mid branch
    E = torch.exp(-dt)
    # J_k = int_0^dt t^k e^{t-dt} dt / dt^k
    J0 = 1.0 - E
    J1 = dt - J0
    J2 = dt * dt - 2.0 * J1
    w_up_mid = J0 - 2.0 * J1 / dt + J2 / (dt * dt)
    w_ctrl_mid = 2.0 * (J1 / dt - J2 / (dt * dt))
    w_c_mid = J2 / (dt * dt)

    # small-dtau series (J2/dt^2 cancels catastrophically otherwise); the
    # divisions by 36, 90, 360 and 6 true divisions on every device, as
    # in linear_weights and the kernel (csrc/formal.cuh)
    d = dtau
    c36, c90, c360, c6 = (torch.full((), v, dtype=d.dtype, device=d.device)
                          for v in (36.0, 90.0, 360.0, 6.0))
    w_up_small = d * (1.0 / 3.0 + d * (-0.25 + d * (0.1 - d / c36)))
    w_ctrl_small = d * (1.0 / 3.0 + d * (-1.0 / 6.0
                                         + d * (0.05 - d / c90)))
    w_c_small = d * (1.0 / 3.0 + d * (-1.0 / 12.0
                                      + d * (1.0 / 60.0 - d / c360)))
    exp_small = 1.0 - d + 0.5 * d * d - d * d * d / c6

    # large-dtau limit (E -> 0; true dtau, not the mid-branch clip); a
    # Python float over a tensor is reciprocal() * the float on every
    # device (Tensor.__rtruediv__), as the kernel reproduces it
    dl = torch.clamp(dtau, min=1.0)
    w_up_large = 2.0 / (dl * dl)
    w_ctrl_large = 2.0 / dl - 4.0 / (dl * dl)
    w_c_large = 1.0 - 2.0 / dl + 2.0 / (dl * dl)

    small = dtau < 0.05
    large = dtau > 50.0
    w_up = torch.where(small, w_up_small,
                       torch.where(large, w_up_large, w_up_mid))
    w_ctrl = torch.where(small, w_ctrl_small,
                         torch.where(large, w_ctrl_large, w_ctrl_mid))
    w_c = torch.where(small, w_c_small,
                      torch.where(large, w_c_large, w_c_mid))
    expdt = torch.where(small, exp_small, torch.where(large, 0.0, E))
    return w_up, w_c, w_ctrl, expdt


def bezier_control(S_uu, S_up, S_c, dtau_uu, dtau, first=0.0):
    """Monotonicity-limited Bezier control point at the upwind node
    (Steffen 1990 limited derivative; first=1 falls back to the secant
    slope, where the Bezier update equals the linear one)."""
    eps = 1e-300 if S_up.dtype == torch.float64 else 1e-30
    h1 = torch.clamp(dtau_uu, min=eps)
    h2 = torch.clamp(dtau, min=eps)
    d1 = (S_up - S_uu) / h1
    d2 = (S_c - S_up) / h2
    p = (d1 * h2 + d2 * h1) / (h1 + h2)
    slope = torch.where(
        d1 * d2 > 0.0,
        torch.sign(d2) * torch.minimum(torch.abs(p),
                                       2.0 * torch.minimum(torch.abs(d1),
                                                           torch.abs(d2))),
        0.0)
    slope = (1.0 - first) * slope + first * d2
    return S_up + 0.5 * dtau * slope
