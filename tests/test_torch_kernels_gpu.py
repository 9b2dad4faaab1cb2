"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without them it skips (the
fixture decides, at run time).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The file imports no JAX, so it also runs where only PyTorch is installed.
Levels, hats and packed bytes must be bitwise equal to the plain versions.
The SSD kernel (K6) takes its products on the tensor cores in 3xTF32 and sums
in another order than its plain version: it is held to
max |kernel - plain| <= 1e-5 * max |plain| (bf16 inputs are the same rounded
values on both sides, so the bound is the same).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import ssm

pytestmark = pytest.mark.gpu

SIZES = [1, 127, 128, 129, 700, 33_000]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
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


@pytest.mark.parametrize("n", [33_001, 4_096 + 8, 4_096, 65_536, 256 * 1001])
@pytest.mark.parametrize("rows", [3, 6])
def test_unpack_kernel_any_row_alignment(cuda, n, rows):
    """Rows start at row * n: with n % 16 != 0 all but the first start off
    16-byte alignment and take the kernel's byte loop; with n a multiple of
    256 every group is whole and takes the 16-byte path."""
    rng = np.random.default_rng(n + rows)
    q = torch.from_numpy(rng.integers(0, 16, (rows, n), dtype=np.uint8)).to(cuda)
    pk = pack_ops.pack4_ref(q)
    before = kernels.LAUNCHES["unpack4"]
    un = pack_ops.unpack4(pk, n)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["unpack4"] == before + 1
    _assert_bitwise(un, pack_ops.unpack4_ref(pk, n))
    _assert_bitwise(un, q)


def test_wrappers_raise_on_bad_input(cuda):
    q = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pack_ops.pack4(q)
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError):
        q_ops.quantize_dequantize(x.t(), x.t(), x.t(), 1.0, 15.0)


SSD_REL = 1e-5


def _ssd_inputs(bc, q, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bc, q, h, p))
    dt = np.log1p(np.exp(rng.normal(size=(bc, q, h))))
    la = np.cumsum(-np.abs(rng.normal(size=(bc, q, h))) * 0.3, axis=1)
    b = rng.normal(size=(bc, q, n))
    c = rng.normal(size=(bc, q, n))
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, dt, la, b, c)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 256, 80, 64, 128),          # mamba2-2.7b's chunk, two rows
    (2, 8, 5, 16, 16), (2, 32, 80, 16, 16), (2, 200, 5, 16, 16),
    (3, 200, 80, 64, 128), (1, 64, 17, 65, 130),
    (1, 768, 16, 64, 128),          # the longest chunk: three spans of keys
    (2, 300, 8, 64, 128),           # uneven tiles past 256 keys
    (2, 128, 13, 64, 128),          # H not a multiple of the head group
])
def test_ssd_kernel_matches_plain(cuda, shape, dtype):
    ins = [t.to(dtype).to(cuda) for t in _ssd_inputs(*shape, seed=sum(shape))]
    before = kernels.LAUNCHES["ssd_intra"]
    y = ssd_ops.ssd_intra(*ins)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ssd_intra"] == before + 1
    ref = ssd_ops.ssd_intra_ref(*ins)
    assert y.dtype == torch.float32 and y.shape == shape[:4]
    err = float((y - ref).abs().max())
    assert err <= SSD_REL * float(ref.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_steep_decay_is_finite(cuda, dtype):
    """la falls by 200 per step: exp of the differences above the diagonal
    would overflow; the kernel masks the exponent, so y stays finite and
    within the gate."""
    x, dt, la, b, c = _ssd_inputs(2, 256, 12, 64, 128, seed=4)
    la = torch.cumsum(torch.full_like(la, -200.0), dim=1)
    ins = [t.to(dtype).to(cuda) for t in (x, dt, la, b, c)]
    y = ssd_ops.ssd_intra(*ins)
    ref = ssd_ops.ssd_intra_ref(*ins)
    assert torch.isfinite(y).all()
    err = float((y - ref).abs().max())
    assert err <= SSD_REL * float(ref.abs().max()), err


def test_ssd_kernel_has_no_backward(cuda):
    x, dt, la, b, c = (t.to(cuda) for t in _ssd_inputs(1, 8, 2, 4, 4, 0))
    x.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd_ops.ssd_intra(x, dt, la, b, c)
    with torch.no_grad():                     # no gradient needed: launches
        ssd_ops.ssd_intra(x, dt, la, b, c)


def test_ssd_scan_two_groups_card_vs_cpu(cuda):
    rng = np.random.default_rng(9)
    bsz, s, h, p, g, n = 2, 300, 8, 16, 2, 16
    arrs = [rng.normal(size=(bsz, s, h, p)),
            np.log1p(np.exp(rng.normal(size=(bsz, s, h)) - 1.0)),
            np.log(np.linspace(1.0, 16.0, h)),
            rng.normal(size=(bsz, s, g, n)), rng.normal(size=(bsz, s, g, n))]
    cpu = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    before = kernels.LAUNCHES["ssd_intra"]
    y, st = ssm.ssd_scan(*(t.to(cuda) for t in cpu), chunk=128)
    assert kernels.LAUNCHES["ssd_intra"] == before + g
    y_ref, st_ref = ssm.ssd_scan(*cpu, chunk=128)
    for a, b in ((y, y_ref), (st, st_ref)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), err


@pytest.mark.parametrize("sizes,bits", [
    ((256,), (4,)), ((100, 200), (2, 8)), ((7, 0, 300, 65), (8, 4, 3, 5)),
    ((0, 0), (1, 8)), ((1000, 1, 129), (4, 1, 6))])
def test_pack_mixed_matches_plain(cuda, sizes, bits):
    """pack_mixed / unpack_mixed on the card (pack4 / unpack4 per <= 4-bit
    segment) against their plain versions, byte for byte."""
    rng = np.random.default_rng(sum(sizes))
    q = torch.from_numpy(np.concatenate(
        [rng.integers(0, 2 ** b, n, dtype=np.uint8)
         for n, b in zip(sizes, bits)] + [np.zeros(0, np.uint8)]))
    packed_segs = sum(1 for n, b in zip(sizes, bits) if n and b <= 4)
    kernels.reset_launches()
    pk = pack_ops.pack_mixed(q.to(cuda), sizes, bits)
    un = pack_ops.unpack_mixed(pk, sizes, bits)
    assert kernels.LAUNCHES["pack4"] == kernels.LAUNCHES["unpack4"] \
        == packed_segs
    _assert_bitwise(pk.cpu(), pack_ops.pack_mixed_ref(q, sizes, bits))
    _assert_bitwise(un.cpu(), q)
