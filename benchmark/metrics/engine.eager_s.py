"""engine.eager_s: device seconds an iteration in the program's eager
engine phases (the spans that launch no layer's kernel: damping,
boundary, J accumulation, transposes, S update, populations, criterion
and the like), each timed between CUDA events at its edges; the median
over the first traced window's iterations (the card profiled alone),
from voronoirt_tpu_torch.observability's iteration records.  None
without a card or where the program records no device times.  Layer:
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
    return statistics.median(sum(r["device_s"].values())
                             for r in traced[:n])
