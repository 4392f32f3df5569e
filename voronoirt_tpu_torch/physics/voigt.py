"""Voigt profile via the Humlicek (1982) w4 rational approximation.

Port of voronoirt_tpu/physics/voigt.py (Transparency.jl voigt_profile,
called from src/line.jl:92 and src/rates.jl:388).

H(a, v) = Re[w(v + i a)]; phi(a, v, dlamD) = H / (sqrt(pi) dlamD).

The complex type follows the input: complex128 for float64 inputs on
every device (the JAX package drops to complex64 off the CPU only
because of the TPU), complex64 for float32.  All four regions are
evaluated and selected with torch.where, as in the JAX package.  voigt_H
walks the input in slabs of _SLAB points, so the dozen complex
temporaries of one slab (0.27 GB each in complex128) bound its memory
whatever the caller's shape.
"""

import numpy as np
import torch

from . import tensors

_SQRT_PI = float(np.sqrt(np.pi))
_SLAB = 1 << 24


def humlicek_w(a, v):
    """Complex probability function w(z), z = v + i a, for a >= 0."""
    a, v = torch.broadcast_tensors(*tensors(a, v))
    # Humlicek works with t = a - i v
    t = torch.complex(a, -v)
    s = torch.abs(v) + a

    # Region I: s >= 15
    w1 = t * 0.5641896 / (0.5 + t * t)

    # Region II: 5.5 <= s < 15
    u2 = t * t
    w2 = t * (1.410474 + u2 * 0.5641896) / (0.75 + u2 * (3.0 + u2))

    # Region III: s < 5.5 and a >= 0.195|v| - 0.176
    w3 = (16.4955 + t * (20.20933 + t * (11.96482 + t * (3.778987 + t * 0.5642236)))) / (
        16.4955 + t * (38.82363 + t * (39.27121 + t * (21.69274 + t * (6.699398 + t))))
    )

    # Region IV: s < 5.5 and a < 0.195|v| - 0.176
    u4 = t * t
    # clip the real part of u4 so exp never overflows in the unselected
    # branch
    u4c = torch.complex(torch.clamp(u4.real, -690.0, 690.0), u4.imag)
    numer = t * (36183.31 - u4 * (3321.9905 - u4 * (1540.787 - u4 * (
        219.0313 - u4 * (35.76683 - u4 * (1.320522 - u4 * 0.56419))))))
    denom = 32066.6 - u4 * (24322.84 - u4 * (9022.228 - u4 * (
        2186.181 - u4 * (364.2191 - u4 * (61.57037 - u4 * (1.841439 - u4))))))
    w4 = torch.exp(u4c) - numer / denom

    return torch.where(s >= 15.0, w1,
           torch.where(s >= 5.5, w2,
           torch.where(a >= 0.195 * torch.abs(v) - 0.176, w3, w4)))


def voigt_H(a, v):
    """Voigt function H(a, v) = Re[w(v + i a)], evaluated slab-wise."""
    a, v = torch.broadcast_tensors(*tensors(a, v))
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    fa, fv, fo = a.reshape(-1), v.reshape(-1), out.view(-1)
    for s in range(0, fo.numel(), _SLAB):
        fo[s:s + _SLAB] = humlicek_w(fa[s:s + _SLAB], fv[s:s + _SLAB]).real
    return out


def voigt_profile(a, v, dlamD):
    """Normalized Voigt profile [1/m]: H(a, v) / (sqrt(pi) dlamD)."""
    return voigt_H(a, v) / (_SQRT_PI * dlamD)



def doppler_profile(dlam, dlamD):
    """Pure Doppler profile [1/m] (src/line.jl:165-167)."""
    dlam, dlamD = tensors(dlam, dlamD)
    return torch.exp(-((dlam / dlamD) ** 2)) / (_SQRT_PI * dlamD)
