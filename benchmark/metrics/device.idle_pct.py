"""device.idle_pct: the share of the traced window in which no operation
ran on the card, from the union of the device operations' intervals in
the profiler's trace (overlapping operations count once).  Layer: the
device.  Moves iter_s."""


def read(run):
    t = run.trace
    if t is None or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
