"""The streamed iteration's S update of one lambda chunk: CUDA kernel
wrapper + plain version.

Counterpart of voronoirt_tpu/engine/lambda_iter.py:236 _s_update_stream,
which the JAX package compiles into one program a lambda chunk: the
chunk's S_new = (1 - eps) J + eps B with the Planck chunk B recomputed
(no resident B0 cube), the convergence criterion's partial maximum of
|S_new - S_old| / |S_new| (|S_new - S_old| where S_new is 0), and S_new
written over the chunk's S_old rows of the full S -- in place here (the
chunk's sweep has consumed S_old by then), where the JAX package
donates S.

Kernel: csrc/rates.cu vrt_s_update (S1), one launch a chunk: one thread
a cell over the chunk's rows, each point read and written once, the
maximum folded a block and into a 0-d tensor on the card with one
atomicMax on its bit pattern (a NaN anywhere gives NaN, as torch.max);
nothing is read back to the host.  In the plain version's arithmetic on
the card, so the two agree bit for bit there.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..physics.planck import _HC_OVER_K, B_lambda, _LOG_2HC2_IUNIT

# kernel launches so far (not counting the plain version)
LAUNCHES = 0
# the int type whose bits hold a maximum of each float type
_BITS = {torch.float64: torch.int64, torch.float32: torch.int32}


def s_update_stream_plain(S, Jc, eps, T, lam_c, start):
    """The plain PyTorch version of s_update_stream."""
    S_old_c = S[start:start + Jc.shape[0]]
    B0_c = B_lambda(lam_c.reshape((-1,) + (1,) * T.dim()), T[None])
    S_new_c = ((1.0 - eps)[None] * Jc + eps[None] * B0_c).to(S.dtype)
    denom = torch.where(S_new_c != 0.0, S_new_c, 1.0)
    m = torch.max(torch.abs(S_new_c - S_old_c) / torch.abs(denom))
    S_old_c.copy_(S_new_c)
    return S, m


def _check(S, Jc, eps, T, lam_c, start):
    if T.dtype not in _BITS:
        raise TypeError(f"unsupported dtype {T.dtype}")
    for name, t in (("S", S), ("Jc", Jc), ("eps", eps), ("lam_c", lam_c)):
        if t.dtype != T.dtype or t.device != T.device:
            raise ValueError(f"{name} must be {T.dtype} on {T.device}, got "
                             f"{t.dtype} on {t.device}")
    cells = tuple(T.shape)
    nb = Jc.shape[0] if Jc.dim() else 0
    if tuple(Jc.shape) != (nb,) + cells or nb == 0:
        raise ValueError(f"Jc must be (B >= 1,) + {cells}, got "
                         f"{tuple(Jc.shape)}")
    if tuple(eps.shape) != cells:
        raise ValueError(f"eps must be {cells}, got {tuple(eps.shape)}")
    if tuple(lam_c.shape) != (nb,):
        raise ValueError(f"lam_c must be ({nb},), got {tuple(lam_c.shape)}")
    if S.dim() != Jc.dim() or tuple(S.shape[1:]) != cells or \
            not 0 <= start <= S.shape[0] - nb:
        raise ValueError(f"S must hold rows [{start}, {start + nb}) of "
                         f"cells {cells}, got {tuple(S.shape)}")


def s_update_stream(S, Jc, eps, T, lam_c, start):
    """The S update of the chunk Jc (B,) + cells of J, rows [start, start
    + B) of S (nlam,) + cells, written into S in place: returns (S, m),
    m the 0-d maximum of |S_new - S_old| / |S_new, or 1 where it is 0|.
    eps and T are per cell, lam_c the chunk's wavelengths (B,)."""
    _check(S, Jc, eps, T, lam_c, start)
    if T.device.type == "cpu":
        return s_update_stream_plain(S, Jc, eps, T, lam_c, start)
    from ..kernels import build
    S_c = S[start:start + Jc.shape[0]]
    if not all(t.is_contiguous() for t in (S_c, Jc, eps, T, lam_c)):
        raise ValueError("s_update kernel inputs must be contiguous")
    # the Planck prefactor of each row, as B_lambda forms it
    pre = torch.exp(_LOG_2HC2_IUNIT - 5.0 * torch.log(lam_c))
    bits = torch.zeros((), dtype=_BITS[T.dtype], device=T.device)
    fn = build.launch_fn("vrt_s_update", T.dtype)
    global LAUNCHES
    with torch.cuda.device(T.device):
        err = fn(Jc.data_ptr(), S_c.data_ptr(), eps.data_ptr(),
                 T.data_ptr(), lam_c.data_ptr(), pre.data_ptr(), T.numel(),
                 Jc.shape[0], _HC_OVER_K, 1e-9, bits.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, "s_update")
    LAUNCHES += int(T.numel() > 0)
    return S, bits.view(T.dtype)
