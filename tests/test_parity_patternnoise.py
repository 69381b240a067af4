"""Pattern-noise removal parity vs the reference C implementation."""

import numpy as np
import pytest

import jax.numpy as jnp

from mlvfs_tpu.ops.patternnoise import fix_pattern_noise_batch

from . import oracle

pytestmark = pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")


def _noisy_frame(h, w, seed=0):
    """Flat-ish scene + per-column and per-row FPN + shot noise + an edge."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 4000.0)
    img += rng.normal(0, 15, (h, w))
    col_fpn = rng.normal(0, 6, w // 2)
    row_fpn = rng.normal(0, 5, h // 2)
    img[:, 0::2] += col_fpn[None, : (w + 1) // 2][:, : img[:, 0::2].shape[1]]
    img[0::2, :] += row_fpn[: (h + 1) // 2, None][: img[0::2, :].shape[0]]
    img[:, w // 3 : w // 3 + 4] += 3000  # strong vertical edge → mask path
    img[h // 2 :, :] += 800  # horizontal brightness step
    img[5:9, 5:9] = 15500  # near-white blob → white mask path
    return np.clip(img, 0, 16383).astype(np.uint16)


@pytest.mark.parametrize("size", [(64, 96)])
def test_pattern_noise_parity(size):
    h, w = size
    img = _noisy_frame(h, w)
    ref = oracle.fix_pattern_noise(img.astype(np.int16), white=15000).astype(np.uint16)
    ours = np.asarray(fix_pattern_noise_batch(jnp.asarray(img[None]), 15000))[0]
    np.testing.assert_array_equal(ref, ours)


def test_pattern_noise_small_dimensions_parity():
    """Frames whose half-res dimension is below the +-25 blur window (e.g.
    40 px tall -> 20 half-res rows for the transposed row pass) must still
    match the reference bit-for-bit — its scan loops clamp at the borders
    (patternnoise.c:123-144) so the window just shrinks. Found by
    tools/fuzz_oracle.py: _shift_cols produced a wrong-width array when the
    shift exceeded the row length, crashing the op at these geometries."""
    rng = np.random.default_rng(3)
    for h, w in ((40, 124), (24, 32), (16, 64)):
        img = rng.integers(0, 15000, (h, w)).astype(np.uint16)
        ref = oracle.fix_pattern_noise(img.astype(np.int16), white=15000).astype(np.uint16)
        ours = np.asarray(fix_pattern_noise_batch(jnp.asarray(img[None]), 15000))[0]
        np.testing.assert_array_equal(ref, ours, err_msg=f"{h}x{w}")


def test_pattern_noise_odd_dimensions():
    """Odd frame sizes (real: EOSM crop 1808x727) process the even-cropped
    region and pass the last row/column through. The reference C has no
    defined semantics here — extract_channel writes ceil(h/2) rows into a
    h/2-row buffer (patternnoise.c:287-296 vs :315-328), a heap overflow —
    so this is a defined-behavior divergence, not an oracle gate."""
    rng = np.random.default_rng(11)
    for h, w in ((97, 160), (96, 161), (97, 161)):
        img = rng.integers(0, 15000, size=(h, w), dtype=np.int64).astype(np.uint16)
        out = np.asarray(fix_pattern_noise_batch(jnp.asarray(img[None]), 15000))[0]
        he, we = h & ~1, w & ~1
        want_core = np.asarray(
            fix_pattern_noise_batch(jnp.asarray(img[None, :he, :we]), 15000)
        )[0]
        np.testing.assert_array_equal(out[:he, :we], want_core)
        np.testing.assert_array_equal(out[he:, :], img[he:, :])
        np.testing.assert_array_equal(out[:, we:], img[:, we:])
