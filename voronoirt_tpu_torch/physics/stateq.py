"""Statistical equilibrium: batched 2x2 population solve.

Port of voronoirt_tpu/physics/stateq.py (reference src/populations.jl:
147-221): the 2x2 inverse written out per cell.
"""

import torch


def get_revised_populations(R, C, atom_density):
    """Solve statistical equilibrium for the 3-level atom.

    R, C: dicts {(i, j): tensor} of radiative / collisional rates i->j
    (0-based levels, 2 = continuum).  Returns populations (..., 3).
    """
    P = {k: R[k] + C[k] for k in R}

    A00 = P[(0, 1)] + P[(1, 0)] + P[(1, 2)]
    A01 = P[(0, 1)] - P[(2, 1)]
    A10 = P[(0, 2)] - P[(1, 2)]
    A11 = P[(0, 2)] + P[(2, 0)] + P[(2, 1)]

    # n_total is factored out of b so the Cramer numerators stay within
    # float32 range
    det = A00 * A11 - A01 * A10
    n2 = atom_density * ((A11 * P[(0, 1)] - A01 * P[(0, 2)]) / det)
    n3 = atom_density * ((A00 * P[(0, 2)] - A10 * P[(0, 1)]) / det)
    n1 = atom_density - n2 - n3
    return torch.stack([n1, n2, n3], dim=-1)
