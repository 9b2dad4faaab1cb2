"""Wrapper of the intra-chunk SSD kernel (``csrc/ssd.cu``).

Counterpart of ``repro/kernels/ssd/ops.py:ssd_intra``.  A CUDA tensor always
goes to the kernel (or the call raises); a CPU tensor takes the plain version
in ``ref.py``.  There is no fallback between the two.  The kernel has no
backward (nor has the JAX package's), so on the card a call that autograd
would need a gradient through raises.

Precision: the kernel takes both of its products (C.B^T and W.x) on the
tensor cores in 3xTF32: each float32 operand is split into two TF32 parts
and three of the four part products are summed in float32.  That is
float32-accurate (about 1e-6 of max |y| at the serving shape), not bitwise
equal to the plain version, which sums in another order; the card's tests
hold the two to 1e-5 x max |y|.  TF32 alone (about 6e-4) would not pass.
bf16 inputs are exact in TF32, so their low parts are skipped.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .. import check_launch
from .ref import ssd_intra_ref  # noqa: F401  (re-export)

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("ssd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd_intra.argtypes = [i, p, p, p, p, p, p, ctypes.c_longlong,
                                        i, i, i, i, p]
        lib.repro_ssd_intra.restype = i
        lib.repro_ssd_max_q.argtypes = []
        lib.repro_ssd_max_q.restype = i
        lib.repro_ssd_error_string.argtypes = [i]
        lib.repro_ssd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ssd_intra(x: Tensor, dt: Tensor, la: Tensor, b: Tensor, c: Tensor
              ) -> Tensor:
    """Intra-chunk SSD for one B/C group.  x: (BC, Q, H, P); dt, la:
    (BC, Q, H); b, c: (BC, Q, N); all float32 or all bfloat16, on one device.
    Returns y (BC, Q, H, P) float32 (see ``ref.ssd_intra_ref``)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (BC, Q, H, P), got {tuple(x.shape)}")
    bc, q, h, p = x.shape
    for name, t in (("dt", dt), ("la", la)):
        if t.shape != (bc, q, h):
            raise ValueError(f"{name} must be {(bc, q, h)}, got {tuple(t.shape)}")
    if b.dim() != 3 or b.shape[:2] != (bc, q) or c.shape != b.shape:
        raise ValueError(f"b and c must be ({bc}, {q}, N), got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    ts = (x, dt, la, b, c)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ts):
        raise TypeError("x, dt, la, b and c must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("x, dt, la, b and c must share a device")
    if x.device.type == "cpu":
        return ssd_intra_ref(*ts)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "ssd_intra has no backward kernel on the card (nor has the JAX "
            "package): SSM training on the card is ROADMAP Queue 1 item 10")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, dt, la, b and c must be contiguous")
    y = torch.empty((bc, q, h, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    if q > lib.repro_ssd_max_q():
        raise ValueError(f"chunk length {q} > {lib.repro_ssd_max_q()}, the "
                         "most the kernel keeps in shared memory")
    rc = lib.repro_ssd_intra(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
                             la.data_ptr(), b.data_ptr(), c.data_ptr(),
                             y.data_ptr(), bc, q, h, p, b.shape[2],
                             torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, "repro_ssd_error_string", rc, "ssd_intra")
    return y
