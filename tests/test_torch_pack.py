"""The port's nibble pack / unpack (plain version, CPU) against the JAX
package's ``pack4_ref``/``unpack4_ref`` and its Pallas ``pack4``/``unpack4``
in interpret mode: byte-identical wire buffers, identical ``packed_len``, and
the batched-rows layout the trainer sends (each row exactly ``pack4(row)``).
The port's CUDA kernels are held against this plain version on the card
(tests/test_torch_kernels_gpu.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pack import pack as jp_kernel
from repro.kernels.pack import ref as jp_ref
from repro_torch.kernels.pack import ops as tp

SIZES = [1, 128, 129, 255, 256, 257, 1000]


def _levels(shape, seed):
    return np.random.default_rng(seed).integers(0, 16, shape, dtype=np.uint8)


@pytest.mark.parametrize("n", SIZES)
def test_pack_matches_jax(n):
    q = _levels((n,), n)
    assert tp.packed_len(n) == jp_ref.packed_len(n)
    pk_t = tp.pack4(torch.from_numpy(q)).numpy()
    pk_ref = np.asarray(jp_ref.pack4_ref(jnp.asarray(q)))
    pk_pallas = np.asarray(jp_kernel.pack4(jnp.asarray(q), interpret=True))
    np.testing.assert_array_equal(pk_t, pk_ref)
    np.testing.assert_array_equal(pk_t, pk_pallas)
    un_t = tp.unpack4(torch.from_numpy(pk_t), n).numpy()
    np.testing.assert_array_equal(
        un_t, np.asarray(jp_ref.unpack4_ref(jnp.asarray(pk_ref), n)))
    np.testing.assert_array_equal(
        un_t, np.asarray(jp_kernel.unpack4(jnp.asarray(pk_ref), n,
                                           interpret=True)))
    np.testing.assert_array_equal(un_t, q)


@pytest.mark.parametrize("n", [1, 257, 1000])
def test_batched_rows_are_single_row_format(n):
    """A (rows, n) batch packs to (rows, packed_len(n)), row i byte-equal to
    the JAX package's pack4 of row i, and unpacks back."""
    q = _levels((3, n), n + 1)
    pk = tp.pack4(torch.from_numpy(q))
    assert pk.shape == (3, jp_ref.packed_len(n))
    for i in range(3):
        np.testing.assert_array_equal(
            pk[i].numpy(), np.asarray(jp_ref.pack4_ref(jnp.asarray(q[i]))))
    np.testing.assert_array_equal(tp.unpack4(pk, n).numpy(), q)


def test_high_bits_follow_jax():
    """Levels >= 16 are outside the format; the port ORs them as the JAX
    package does (uint8 arithmetic), so even misuse is byte-identical."""
    q = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tp.pack4(torch.from_numpy(q)).numpy(),
        np.asarray(jp_ref.pack4_ref(jnp.asarray(q))))


def test_unpack_rejects_wrong_length():
    with pytest.raises(ValueError):
        tp.unpack4(torch.zeros(100, dtype=torch.uint8), 300)
    with pytest.raises(TypeError):
        tp.pack4(torch.zeros(10, dtype=torch.int32))
