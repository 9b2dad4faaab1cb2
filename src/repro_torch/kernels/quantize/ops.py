"""Wrapper of the fused codec kernel (``csrc/quantize.cu``).

Counterpart of ``repro/kernels/quantize/quantize.py:quantize_dequantize``.  A
CUDA tensor always goes to the kernel (or the call raises); a CPU tensor takes
the plain version in ``ref.py``.  There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .. import check_launch
from .ref import decode_ref, quantize_dequantize_ref  # noqa: F401  (re-export)

Tensor = torch.Tensor

_MODES = {0: "quantize_dequantize", 1: "quantize_dequantize_vec_r",
          2: "quantize_dequantize_vec_rl"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("quantize")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.repro_qdq.argtypes = [ctypes.c_int, ctypes.c_int, p, p, p, p, p, p,
                                  p, ctypes.c_longlong, ctypes.c_longlong, p]
        lib.repro_qdq.restype = ctypes.c_int
        lib.repro_qdq_error_string.argtypes = [ctypes.c_int]
        lib.repro_qdq_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _per_value(v, theta: Tensor, name: str) -> tuple[Tensor, bool]:
    """radius/levels -> (f32 tensor broadcastable against theta,
    is-per-element).  Accepts a Python number, a 0-d tensor,
    one value per row ((rows,) for a 2-D theta) or one per element."""
    if not isinstance(v, Tensor):
        v = torch.tensor(float(v), dtype=torch.float32, device=theta.device)
    if v.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {v.dtype}")
    if v.device != theta.device:
        raise ValueError(f"{name} is on {v.device}, theta on {theta.device}")
    if v.shape == theta.shape:
        return v, True
    if v.dim() == 0:
        return (v.expand(theta.shape[0], 1) if theta.dim() == 2 else v), False
    if theta.dim() == 2 and v.shape == (theta.shape[0],):
        return v.reshape(-1, 1), False
    raise ValueError(f"{name} of shape {tuple(v.shape)} is neither a scalar, "
                     f"one value per row nor per element of {tuple(theta.shape)}")


def quantize_dequantize(theta: Tensor, theta_hat_prev: Tensor, u: Tensor,
                        radius, levels) -> tuple[Tensor, Tensor]:
    """Stochastically quantize theta - theta_hat_prev; return (q uint8, hat).

    theta, theta_hat_prev: (n,) or (rows, cols), same shape and dtype (f32 or
    bf16); u: f32 uniform draw of the same shape.  radius and levels: a
    scalar, one value per row, or one per element (see ref.py).  The kernel
    variant follows: per-element levels -> vec_rl (radius expanded),
    per-element radius -> vec_r, otherwise the per-row scalar form."""
    if theta.dim() not in (1, 2):
        raise ValueError(f"theta must be 1-D or 2-D, got {tuple(theta.shape)}")
    if theta_hat_prev.shape != theta.shape or u.shape != theta.shape:
        raise ValueError("theta, theta_hat_prev and u must share a shape")
    if theta_hat_prev.dtype != theta.dtype or theta.dtype not in _DTYPES:
        raise TypeError("theta and theta_hat_prev must both be float32 or "
                        f"bfloat16, got {theta.dtype}/{theta_hat_prev.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"u must be float32, got {u.dtype}")
    if theta_hat_prev.device != theta.device or u.device != theta.device:
        raise ValueError("theta, theta_hat_prev and u must share a device")
    r, r_elem = _per_value(radius, theta, "radius")
    lv, lv_elem = _per_value(levels, theta, "levels")
    if theta.device.type == "cpu":
        return quantize_dequantize_ref(theta, theta_hat_prev, u, r, lv)
    if theta.device.type != "cuda":
        raise ValueError(f"unsupported device {theta.device}")
    for name, t in (("theta", theta), ("theta_hat_prev", theta_hat_prev),
                    ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q = torch.empty(theta.shape, dtype=torch.uint8, device=theta.device)
    hat = torch.empty_like(theta_hat_prev)
    if theta.numel() == 0:
        return q, hat
    rows, cols = (theta.shape if theta.dim() == 2 else (1, theta.shape[0]))
    if rows > 65535:
        raise ValueError(f"at most 65535 rows, got {rows}")
    mode = 2 if lv_elem else (1 if r_elem else 0)
    if mode == 2 and not r_elem:
        r = r.reshape(-1, 1).expand(rows, cols).reshape(theta.shape)
    r = (r if r_elem or mode == 2 else r.reshape(-1)).contiguous()
    lv = (lv if lv_elem else lv.reshape(-1)).contiguous()
    lib = _lib()
    rc = lib.repro_qdq(mode, _DTYPES[theta.dtype], theta.data_ptr(),
                       theta_hat_prev.data_ptr(), u.data_ptr(), r.data_ptr(),
                       lv.data_ptr(), q.data_ptr(), hat.data_ptr(), rows, cols,
                       torch.cuda.current_stream(theta.device).cuda_stream)
    check_launch(lib, "repro_qdq_error_string", rc, _MODES[mode])
    return q, hat
