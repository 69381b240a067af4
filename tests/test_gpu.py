"""Checks that only mean something on a GPU (marker `gpu`; they skip
elsewhere). Run on a machine with a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_evarith_cores_bit_exact_on_the_gpu(gpu):
    """XLA:GPU may contract multiply-adds; the double-single cores must
    still be bit-exact there."""
    from mlvfs_tpu.ops import evarith

    with jax.default_device(gpu):
        evarith.check_cores()


def test_unpack_on_the_gpu(gpu, rng):
    from mlvfs_tpu.format.bits import pack_bits_np
    from mlvfs_tpu.ops.unpack import unpack_batch, words_for_pixels

    h, w, bpp = 1080, 1920, 14
    frame = rng.integers(0, 1 << bpp, (h, w), dtype=np.uint16)
    words = pack_bits_np(frame.ravel(), bpp)[: words_for_pixels(h * w, bpp)]
    got = unpack_batch(jax.device_put(jnp.asarray(words[None]), gpu), bpp, h, w)
    assert got.devices() == {gpu}
    np.testing.assert_array_equal(np.asarray(got)[0], frame)
