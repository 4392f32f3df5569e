"""Units-free physics library, ported from voronoirt_tpu.physics."""


def tensors(*xs):
    """The arguments as tensors sharing the dtype and device of the
    first tensor among them (float64 on the CUDA card when none is one),
    so that the JAX package's Python-scalar arguments (a line-centre
    wavelength, say) keep working."""
    import torch
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if ref is None:
        from ..device import require_cuda
        ref = torch.empty((), dtype=torch.float64, device=require_cuda())
    return tuple(torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
                 for x in xs)



# after `tensors`, which the modules import; the JAX package exports it
# from its physics package too
from .voigt import doppler_profile  # noqa: E402
