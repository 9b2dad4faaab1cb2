"""The port's mixed-width wire format (``pack_mixed`` / ``unpack_mixed`` /
``mixed_packed_len``) against the JAX package's, on the CPU (plain
versions): the segment framings of ``tests/test_kernels.py``'s
``test_pack_mixed_roundtrip`` with the same levels (drawn with JAX from the
same keys), byte-identical wire buffers, exact round trips, and the
``test_mixed_packed_len_formula`` cases.  On the card the <= 4-bit segments
go through pack4 / unpack4 (``tests/test_torch_kernels_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pack import ops as jp_ops
from repro_torch.kernels.pack import ops as tp

SEGS = [
    ((256,), (4,)),
    ((100, 200), (2, 8)),
    ((7, 0, 300, 65), (8, 4, 3, 5)),
    ((0, 0), (1, 8)),
    ((1000, 1, 129), (4, 1, 6)),
]


def _levels(sizes, bits):
    key = jax.random.PRNGKey(sum(sizes) + 1)
    segs = [jax.random.randint(jax.random.fold_in(key, i), (sz,), 0, 2 ** b)
            .astype(jnp.uint8) for i, (sz, b) in enumerate(zip(sizes, bits))]
    return np.asarray(jnp.concatenate(segs) if segs
                      else jnp.zeros((0,), jnp.uint8))


@pytest.mark.parametrize("sizes,bits", SEGS)
def test_pack_mixed_matches_jax(sizes, bits):
    q = _levels(sizes, bits)
    want = np.asarray(jp_ops.pack_mixed(jnp.asarray(q), sizes, bits,
                                        impl="ref"))
    pk = tp.pack_mixed(torch.from_numpy(q), sizes, bits)
    assert pk.numel() == tp.mixed_packed_len(sizes, bits) \
        == jp_ops.mixed_packed_len(sizes, bits)
    np.testing.assert_array_equal(pk.numpy(), want)
    np.testing.assert_array_equal(
        tp.unpack_mixed(pk, sizes, bits).numpy(), q)


def test_mixed_packed_len_formula():
    """<= 4-bit segments pay the nibble format (128 ceil(n / 256) bytes),
    wider ones a byte per element, empty ones nothing; a width outside
    1..8 or a framing that does not match the stream raises."""
    assert tp.mixed_packed_len((), ()) == 0
    assert tp.mixed_packed_len((0,), (4,)) == 0
    assert tp.mixed_packed_len((256,), (4,)) == 128
    assert tp.mixed_packed_len((257,), (4,)) == 256
    assert tp.mixed_packed_len((257,), (5,)) == 257
    assert tp.mixed_packed_len((100, 200), (2, 8)) == 128 + 200
    with pytest.raises(ValueError):
        tp.mixed_packed_len((10,), (9,))
    with pytest.raises(ValueError):
        tp.pack_mixed(torch.zeros(11, dtype=torch.uint8), (10,), (4,))
    with pytest.raises(ValueError):
        tp.unpack_mixed(torch.zeros(10, dtype=torch.uint8), (10,), (4,))
