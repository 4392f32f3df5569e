"""engine.setup_s: host seconds in the program's engine.setup span, the
engine's __init__ (its plans, the fields to the card, the frozen set-up
and its charge check, and on a Voronoi grid the slot plans' device
arrays), from voronoirt_tpu_torch.observability's process-wide records.
None where the program records no such span.  Layer: engine.setup.
Moves setup_s."""


def read(run):
    try:
        from voronoirt_tpu_torch.observability import RECORDER
    except ImportError:
        return None
    timer = RECORDER.timer
    if not timer.counts.get("engine.setup"):
        return None
    return timer.totals["engine.setup"]
