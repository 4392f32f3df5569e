"""xy_segment_roofline: the least time of the traced window's calls of
solvers.xy_segment: K1, a piece of an xy segment a call,
over the device time attributed to them, in per cent.  The least time
of a call is the larger of its bytes over 3.35 TB/s and its operations
over the dtype's peak (benchmark/work.py).  Moves iter_s."""


def read(run):
    return run.roofline_pct("xy_segment")
