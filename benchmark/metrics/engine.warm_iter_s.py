"""engine.warm_iter_s: host seconds of the warm-up iteration inside
set-up (the first Lambda iteration, the card synchronised after it).
Layer: engine.lambda_iter.  Moves setup_s."""


def read(run):
    return run.spans.get("warm_iter_s")
