"""Plain PyTorch version of the intra-chunk SSD kernel (Mamba2, G = 1).

Counterpart of ``repro/kernels/ssd/ref.py:ssd_intra_ref``, batched over the
BC = batch * chunks rows.  Written as the JAX oracle's explicit steps (CB,
the masked decay, W, then one batched product with x), so no intermediate
is larger than one (BC, Q, Q, H) float32 tensor: 336 MB at the serving
shape (BC 16, Q 256, H 80), where a single four-operand einsum could pair
its operands into far more.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def ssd_intra_ref(x: Tensor, dt: Tensor, la: Tensor, b: Tensor,
                  c: Tensor) -> Tensor:
    """x: (BC, Q, H, P); dt, la: (BC, Q, H); b, c: (BC, Q, N), float32 or
    bfloat16 (cast to float32).  Returns y (BC, Q, H, P) float32 with

        y[t, h] = sum_{k <= t} (C_t . B_k) exp(la[t,h] - la[k,h]) dt[k,h] x[k,h]

    The exponent is masked, not the result, so the positive differences
    above the diagonal never reach ``exp``."""
    f32 = torch.float32
    x, dt, la, b, c = (t.to(f32) for t in (x, dt, la, b, c))
    q = x.shape[1]
    cb = torch.einsum("btn,bkn->btk", c, b)                    # (BC, Q, Q)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    seg = la[:, :, None, :] - la[:, None, :, :]                # (BC, Q, K, H)
    decay = torch.exp(torch.where(tri[None, :, :, None], seg, float("-inf")))
    del seg
    w = cb[..., None] * decay * dt[:, None, :, :]              # (BC, Q, K, H)
    del decay
    return torch.einsum("btkh,bkhp->bthp", w, x)
