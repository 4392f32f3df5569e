"""march_plane_roofline: the least time of the traced window's calls of
solvers.march_plane: K2, march_coeffs and march_chain, one layer call a
z-plane of the yz / xz march,
over the device time attributed to them, in per cent.  The least time
of a call is the larger of its bytes over 3.35 TB/s and its operations
over the dtype's peak (benchmark/work.py).  Moves iter_s."""


def read(run):
    return run.roofline_pct("march_plane")
