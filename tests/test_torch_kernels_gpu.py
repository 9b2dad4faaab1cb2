"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without them it skips (the
fixture decides, at run time).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The file imports no JAX, so it also runs where only PyTorch is installed.
Levels, hats and packed bytes must be bitwise equal to the plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.quantize import ops as q_ops

pytestmark = pytest.mark.gpu

SIZES = [1, 127, 128, 129, 700, 33_000]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    return torch.device("cuda")


def _codec_inputs(rows, n, dtype, seed, device):
    rng = np.random.default_rng(seed)
    theta = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
    hat = torch.from_numpy(0.5 * rng.normal(size=(rows, n)).astype(np.float32))
    u = torch.from_numpy(rng.random((rows, n), dtype=np.float32))
    theta, hat = theta.to(dtype), hat.to(dtype)
    r = (theta.float() - hat.float()).abs().amax(dim=1)
    r[rows // 2] = 0.0  # one zero-radius row: q = 0, hat unchanged
    return [t.to(device) for t in (theta, hat, u, r)]


def _assert_bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.dtype != torch.uint8 else a,
                       b.view(torch.uint8) if b.dtype != torch.uint8 else b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["row", "vec_r", "vec_rl"])
@pytest.mark.parametrize("n", SIZES)
def test_codec_kernel_matches_plain(cuda, n, mode, dtype):
    rows = 3
    theta, hat, u, r = _codec_inputs(rows, n, dtype, n + 7, cuda)
    levels = torch.full((rows,), 15.0, device=cuda)
    if mode != "row":
        r = r[:, None].expand(rows, n).contiguous()
        r[0, : n // 3] = 0.0  # a zero-radius segment inside a row
    if mode == "vec_rl":
        levels = torch.full((rows, n), 15.0, device=cuda)
        levels[:, n // 2:] = 3.0
    name = {"row": "quantize_dequantize", "vec_r": "quantize_dequantize_vec_r",
            "vec_rl": "quantize_dequantize_vec_rl"}[mode]
    before = kernels.LAUNCHES[name]
    q, h = q_ops.quantize_dequantize(theta, hat, u, r, levels)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    rb = r if mode != "row" else r[:, None]
    lb = levels if mode == "vec_rl" else levels[:, None]
    q_ref, h_ref = q_ops.quantize_dequantize_ref(theta, hat, u, rb, lb)
    _assert_bitwise(q, q_ref)
    _assert_bitwise(h, h_ref)
    # the receiver's plain decode reproduces the sender's hat bitwise
    _assert_bitwise(q_ops.decode_ref(hat, q, rb, lb), h)


def test_codec_kernel_one_row_scalar(cuda):
    theta, hat, u, r = _codec_inputs(1, 1000, torch.float32, 3, cuda)
    q, h = q_ops.quantize_dequantize(theta[0], hat[0], u[0], r[0], 7.0)
    lv = torch.tensor(7.0, device=cuda)
    q_ref, h_ref = q_ops.quantize_dequantize_ref(theta[0], hat[0], u[0], r[0], lv)
    _assert_bitwise(q, q_ref)
    _assert_bitwise(h, h_ref)


@pytest.mark.parametrize("n", [1, 128, 129, 255, 256, 257, 1000, 33_000])
@pytest.mark.parametrize("rows", [1, 4])
def test_pack_kernels_match_plain(cuda, n, rows):
    rng = np.random.default_rng(n)
    q = torch.from_numpy(rng.integers(0, 16, (rows, n), dtype=np.uint8)).to(cuda)
    pk = pack_ops.pack4(q)
    assert pk.shape == (rows, pack_ops.packed_len(n))
    _assert_bitwise(pk, pack_ops.pack4_ref(q))
    un = pack_ops.unpack4(pk, n)
    _assert_bitwise(un, pack_ops.unpack4_ref(pk, n))
    _assert_bitwise(un, q)
    # each batched row is exactly the single-row wire format
    _assert_bitwise(pk[rows - 1], pack_ops.pack4(q[rows - 1].contiguous()))


def test_wrappers_raise_on_bad_input(cuda):
    q = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pack_ops.pack4(q)
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError):
        q_ops.quantize_dequantize(x.t(), x.t(), x.t(), 1.0, 15.0)
