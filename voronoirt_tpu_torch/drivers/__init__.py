"""Command-line drivers of the port, the counterparts of the JAX
package's drivers/*.py.  Run as `python -m voronoirt_tpu_torch.drivers.<name>`;
each has a main(argv=None) that returns the summary it prints as JSON.
They run on the CUDA card unless given --device."""


def pick_device(name):
    """--device's value as a torch.device; None or '' means the CUDA
    card, and raises where none is visible."""
    import torch

    from ..device import require_cuda
    return torch.device(name) if name else require_cuda()
