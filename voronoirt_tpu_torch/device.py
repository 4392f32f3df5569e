"""Device and dtype policy.

Counterpart of the dtype fields of voronoirt_tpu.config.Config
(`dtype`, `transport_dtype` / `sweep_dtype`).  float64 is the default
working type, for validation runs; float32 is the JAX package's
production mode (`--f32`), and then every path runs in float32.
"""

from __future__ import annotations

import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """Map a Config dtype name ('float64' | 'float32') to a torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have "
                         f"{sorted(_DTYPES)}") from None


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required and none is visible")
    return torch.device("cuda", torch.cuda.current_device())

