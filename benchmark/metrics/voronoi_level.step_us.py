"""voronoi_level.step_us: V1's device time in the traced window over the
level steps its calls made (sweep_voronoi.LEVEL_STEPS), in
microseconds.  Layer: solvers.voronoi_level.  Moves iter_s."""


def read(run):
    steps = run.counters.get("level_steps")
    dev = run.trace["layers"].get("voronoi_level") if run.trace else None
    if not steps or not dev:
        return None
    return 1e6 * dev / steps
