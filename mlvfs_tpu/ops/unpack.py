"""Device-side Bayer bitstream unpacking.

Vectorised redesign of the reference's per-pixel fetch+rotate loop
(dng_get_image_data_inline, dng.c:813-843). Rather than a gather per pixel,
we exploit the periodic structure of the packing: at ``bpp`` bits per pixel,
``lcm(16, bpp) / bpp`` pixels occupy ``lcm(16, bpp) / 16`` sixteen-bit words,
so the word stream reshapes into independent fixed-size blocks (e.g. 14bpp →
8 pixels from 7 words, the raw_pixblock of raw.h:63-79). Each output pixel is
then a *static* pair of word columns, a shift, and a mask — pure elementwise
vector ops with no dynamic indexing, which XLA fuses into one loop kernel.

The inverse (pack16) exists for writing MLV-packed data back out and for the
round-trip tests.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def _block_geometry(bpp: int):
    lcm = math.lcm(16, bpp)
    return lcm // bpp, lcm // 16  # pixels per block, words per block


def words_for_pixels(num_pixels: int, bpp: int) -> int:
    """Number of u16 words needed to hold num_pixels (not block-padded)."""
    return (num_pixels * bpp + 15) // 16


def unpack_words(words: jnp.ndarray, bpp: int, num_pixels: int) -> jnp.ndarray:
    """Unpack a u16 word stream → uint16 pixels. jit-compatible, static shapes.

    ``words`` must contain at least ``words_for_pixels(num_pixels, bpp)``
    entries; excess is ignored. Output shape: (num_pixels,).
    """
    ppb, wpb = _block_geometry(bpp)
    num_blocks = (num_pixels + ppb - 1) // ppb
    needed = num_blocks * wpb
    w = words.astype(jnp.uint32)
    if w.shape[0] < needed:
        w = jnp.pad(w, (0, needed - w.shape[0]))
    else:
        w = w[:needed]
    w = w.reshape(num_blocks, wpb)

    mask = (1 << bpp) - 1
    cols = []
    for j in range(ppb):
        off = j * bpp
        a, sh = off >> 4, off & 15
        if sh + bpp <= 16:
            # pixel contained in word a
            val = (w[:, a] >> (16 - bpp - sh)) & mask
        else:
            # straddles words a, a+1 (a+1 < wpb by construction)
            val = ((w[:, a] << 16) | w[:, a + 1]) >> (32 - bpp - sh) & mask
        cols.append(val)
    out = jnp.stack(cols, axis=1).reshape(num_blocks * ppb)
    return out[:num_pixels].astype(jnp.uint16)


def pack16(pixels: jnp.ndarray, bpp: int) -> jnp.ndarray:
    """Inverse of unpack_words: pixels → u16 word stream (block-padded)."""
    ppb, wpb = _block_geometry(bpp)
    n = pixels.shape[0]
    num_blocks = (n + ppb - 1) // ppb
    p = pixels.astype(jnp.uint32)
    if n < num_blocks * ppb:
        p = jnp.pad(p, (0, num_blocks * ppb - n))
    p = p.reshape(num_blocks, ppb)

    words = [jnp.zeros(num_blocks, jnp.uint32) for _ in range(wpb)]
    for j in range(ppb):
        off = j * bpp
        a, sh = off >> 4, off & 15
        if sh + bpp <= 16:
            words[a] = words[a] | (p[:, j] << (16 - bpp - sh))
        else:
            spill = sh + bpp - 16
            words[a] = words[a] | (p[:, j] >> spill)
            words[a + 1] = words[a + 1] | ((p[:, j] << (16 - spill)) & 0xFFFF)
    return jnp.stack(words, axis=1).reshape(num_blocks * wpb).astype(jnp.uint16)


def unpack_frame(words: jnp.ndarray, bpp: int, height: int, width: int) -> jnp.ndarray:
    """Unpack one frame's packed words into an (H, W) uint16 mosaic."""
    return unpack_words(words, bpp, height * width).reshape(height, width)


def unpack_batch(words: jnp.ndarray, bpp: int, height: int, width: int) -> jnp.ndarray:
    """Unpack a batch: (B, n_words) u16 → (B, H, W) uint16."""
    return jax.vmap(lambda ws: unpack_frame(ws, bpp, height, width))(words)


def bytes_to_words_np(payload: np.ndarray) -> np.ndarray:
    """Host-side: reinterpret a little-endian byte buffer as u16 words."""
    b = np.asarray(payload, np.uint8)
    if len(b) % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    return b.view("<u2")


def lj92_detile(img: jnp.ndarray) -> jnp.ndarray:
    """Undo the 2D tiling applied to LJ92-compressed MLV frames.

    The reference scatter (main.c:652-668) maps source row y to
    ``dst_y = (2y) % H + (2y) // H`` (same for columns): first half of the
    rows land on even rows, second half on odd rows — a riffle interleave,
    expressible as reshape/transpose (no gather). For odd dimensions the
    reference mapping is not even a bijection (collisions + uninitialized
    rows); LJ92 MLV frames are always even-sized, so we require that.
    """
    h, w = img.shape[-2], img.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"lj92_detile requires even dimensions, got {h}x{w}")
    lead = img.shape[:-2]
    img = img.reshape(*lead, 2, h // 2, w)
    img = jnp.swapaxes(img, -3, -2).reshape(*lead, h, w)
    img = img.reshape(*lead, h, 2, w // 2)
    img = jnp.swapaxes(img, -2, -1).reshape(*lead, h, w)
    return img
