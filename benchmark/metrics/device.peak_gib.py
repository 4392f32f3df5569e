"""device.peak_gib: torch.cuda.max_memory_allocated() over set-up, the
iterations and the checked iteration, in GiB (before the reference
runs).  Layer: the device.  Moves iter_s: a lower peak admits a larger
wavelength chunk."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2**30
