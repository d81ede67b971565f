"""The port's GPTQ pack formats against the JAX package's numpy functions.

Packing is integer bit manipulation, so every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

from gptqmodel_tpu.ops import pack as jpack
from gptqmodel_tpu_torch.ops import pack as tpack


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qweight_pack_unpack_bit_exact(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, size=(256, 48)).astype(np.int32)
    ref = jpack.pack_qweight(codes, bits)
    got = tpack.pack_qweight(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tpack.unpack_qweight(got, bits).numpy(), codes)
    np.testing.assert_array_equal(
        tpack.unpack_qweight(torch.from_numpy(ref), bits).numpy(),
        jpack.unpack_qweight(ref, bits),
    )


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("v1", [False, True])
def test_qzeros_pack_unpack_bit_exact(bits, v1):
    rng = np.random.default_rng(10 + bits)
    zeros = rng.integers(0, 2**bits, size=(4, 64)).astype(np.int32)
    ref = jpack.pack_qzeros(zeros, bits, v1=v1)
    got = tpack.pack_qzeros(torch.from_numpy(zeros), bits, v1=v1)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tpack.unpack_qzeros(torch.from_numpy(ref), bits, v1=v1).numpy(),
        jpack.unpack_qzeros(ref, bits, v1=v1),
    )


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_convert_qzeros_v1_v2_bit_exact(bits):
    rng = np.random.default_rng(20 + bits)
    zeros = rng.integers(0, 2**bits, size=(8, 32)).astype(np.int32)
    v1 = jpack.pack_qzeros(zeros, bits, v1=True)
    v2 = tpack.convert_qzeros_v1_to_v2(torch.from_numpy(v1), bits)
    np.testing.assert_array_equal(v2.numpy(), jpack.convert_qzeros_v1_to_v2(v1, bits))
    np.testing.assert_array_equal(v2.numpy(), jpack.pack_qzeros(zeros, bits, v1=False))


def test_unsupported_bits_raise():
    """5, 6 and 7 bits have no continuous layout: only planar=True packs them."""
    with pytest.raises(NotImplementedError):
        tpack.pack_qweight(torch.zeros((32, 8), dtype=torch.int32), 5)
