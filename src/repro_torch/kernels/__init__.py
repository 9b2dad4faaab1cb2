"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``LAUNCHES`` counts the kernel launches of every wrapper: a wrapper adds one
where it launches its kernel on a CUDA tensor, and nowhere else (a CPU tensor
takes the plain version and counts nothing).  ``reset_launches`` sets every
count to 0, so a run can show which kernels its main path went through.
"""
from __future__ import annotations

KERNELS = ("quantize_dequantize", "quantize_dequantize_vec_r",
           "quantize_dequantize_vec_rl", "pack4", "unpack4", "ssd_intra")

LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_launch(lib, err_fn: str, rc: int, kernel: str) -> None:
    """Raise on a refused launch (the C entry point returns
    cudaGetLastError() right after launching); count it otherwise."""
    if rc != 0:
        msg = getattr(lib, err_fn)(rc)
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({msg.decode() if msg else '?'})")
    LAUNCHES[kernel] += 1
