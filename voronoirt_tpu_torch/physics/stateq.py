"""Statistical equilibrium: batched 3-level population solve.

Port of voronoirt_tpu/physics/stateq.py (reference src/populations.jl:
147-221), which solves the 2x2 system for (n2, n3) by Cramer's rule and
closes n1 = n_H - n2 - n3.  The port solves the same system in a form
without subtraction (get_revised_populations): the same function in
exact arithmetic, and one formula for every dtype.
"""

import torch


def get_revised_populations(R, C, atom_density):
    """Solve statistical equilibrium for the 3-level atom.

    R, C: dicts {(i, j): tensor} of radiative / collisional rates i->j
    (0-based levels, 2 = continuum).  Returns populations (..., 3).

    With P = R + C, the JAX package solves
      A00 = P01 + P10 + P12        A01 = P01 - P21
      A10 = P02 - P12              A11 = P02 + P20 + P21
      A (n2, n3) = n_H (P01, P02),  n1 = n_H - n2 - n3
    by Cramer: n2 = n_H num2 / det, n3 = n_H num3 / det.  Expanded,
      num2 = A11 P01 - A01 P02 = P01 P20 + P01 P21 + P02 P21
      num3 = A00 P02 - A10 P01 = P02 P10 + P02 P12 + P01 P12
      det  = A00 A11 - A01 A10 = num1 + num2 + num3
      num1 = P10 P20 + P12 P20 + P10 P21,  n1 = n_H num1 / det
    (the matrix-tree form of the three-level balance: each level's
    weight is the sum of the rate products of the spanning trees into
    it).  Every term is positive, so nothing cancels.  The Cramer forms
    cancel in ionised cells: n1 = n_H - n2 - n3 is ~1e-7 of n_H there,
    a few float32 ulps, and A11 P01 - A01 P02 loses P01 P02, so float32
    rounding takes n2 to 0 in hot, thin cells; in float64 the same
    cancellations cost about eps * n_H / n relative.  Here each level is
    a ratio of positive sums, a few ulps off in either dtype, and the
    three add up to n_H to rounding.  n_H multiplies the ratio, not the
    numerators, so the products of rates (up to ~1e26) stay within
    float32 range.
    """
    P = {k: R[k] + C[k] for k in R}
    P01, P10, P02 = P[(0, 1)], P[(1, 0)], P[(0, 2)]
    P20, P12, P21 = P[(2, 0)], P[(1, 2)], P[(2, 1)]

    num1 = P10 * P20 + P12 * P20 + P10 * P21
    num2 = P01 * P20 + P01 * P21 + P02 * P21
    num3 = P02 * P10 + P02 * P12 + P01 * P12
    det = num1 + num2 + num3
    return torch.stack([atom_density * (num1 / det),
                        atom_density * (num2 / det),
                        atom_density * (num3 / det)], dim=-1)
