"""engine.host_waits: the places an iteration's host blocks on the card
(engine.wait spans: the criterion's readback, copies from pageable host
memory, checkpoint copies, relax-lap readbacks), counted by the program;
the median over the first traced window's iterations, from
voronoirt_tpu_torch.observability's iteration records.  None where the
program records no device times (no card) or no records.  Layer:
engine.lambda_iter.  Moves iter_s."""

import statistics


def read(run):
    try:
        from voronoirt_tpu_torch.observability import RECORDER
    except ImportError:
        return None
    traced = [r for r in RECORDER.iterations if r["device_s"] is not None]
    n = len(run.iter_s) // 2
    if not n or len(traced) < n:
        return None
    return statistics.median(r["waits"] for r in traced[:n])
