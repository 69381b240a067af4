"""Fixed-pattern (row/column) noise removal.

Pipeline per direction (reference: fix_pattern_noise patternnoise.c:357-379):
split the Bayer mosaic into 4 half-res channels, run a horizontal edge-aware
median blur (window grows left/right until the green average jumps by more
than a threshold, max ±25), call the difference "noise", mask strong edges
and near-white pixels, subtract each column's median noise, remove the median
of the offsets to avoid a cast; transpose and repeat for rows.

Device mapping of the data-dependent window: the window is a prefix-AND
condition over at most 51 static neighbor offsets, so we materialize the
(51, H/2, W/2) neighborhood (static shifts, no gathers) and take the k-th
smallest valid element — with k derived from the per-pixel valid count —
by exact value-range bisection (~19 compare+reduce passes; an order of
magnitude cheaper than the K-wide sort networks XLA emits). An exact,
branch-free reformulation of the reference's variable-length medians
(horizontal_edge_aware_blur_rggb patternnoise.c:88-180, fix_column_noise
patternnoise.c:185-282). All integer arithmetic matches C semantics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_STRENGTH = 25  # 50/2 (patternnoise.c:104, call site :332)
_THR = 500
_SENTINEL = 1 << 30  # above any reachable int16-domain value


def _wirth_k(num):
    """median_short/int_wirth index: n odd → n//2, even → n//2 - 1 (wirth.h)."""
    return jnp.where((num & 1) == 1, num // 2, num // 2 - 1)


def _masked_median(stack, valid, axis=0, lo=-(1 << 18), hi=1 << 18):
    """k-th smallest of valid elements (exact, integer domain).

    Binary search over the value range instead of jnp.sort: the answer is
    the smallest v with count(valid & stack <= v) >= k+1, found in
    ~log2(range) passes of K compares+adds instead of the K-wide sort
    networks XLA emits (and the take_along_axis it would take to index them
    per-pixel is a gather)."""
    import math as _math

    num = valid.sum(axis=axis)
    k = jnp.clip(_wirth_k(num), 0, stack.shape[axis] - 1)
    iters = int(_math.ceil(_math.log2(hi - lo + 1)))
    lov = jnp.full(num.shape, lo, jnp.int32)
    hiv = jnp.full(num.shape, hi, jnp.int32)
    for _ in range(iters):
        mid = (lov + hiv) >> 1
        cnt = jnp.sum(jnp.where(valid & (stack <= jnp.expand_dims(mid, axis)), 1, 0), axis=axis)
        take = cnt >= k + 1
        hiv = jnp.where(take, mid, hiv)
        lov = jnp.where(take, lov, mid + 1)
    return lov, num


def _shift_cols(a, d, fill):
    """a shifted along axis -1 by d (elements from column x+d), edge-filled."""
    h, w = a.shape
    if d == 0:
        return a
    if abs(d) >= w:
        # whole row shifted out (half-res width below the +-25 blur window,
        # e.g. a 124-px-wide frame): every element is the edge fill
        return jnp.full((h, w), fill, a.dtype)
    if d > 0:
        return jnp.concatenate([a[:, d:], jnp.full((h, d), fill, a.dtype)], axis=1)
    return jnp.concatenate([jnp.full((h, -d), fill, a.dtype), a[:, :d]], axis=1)


def _edge_aware_blur(r, g1, g2, b):
    """Adaptive-window row medians of g1, g2, r-g, b-g (+g back).

    Returns smoothed (rs, g1s, g2s, bs). patternnoise.c:88-180.
    """
    h, w = g1.shape
    avg = (g1.astype(jnp.int32) + g2.astype(jnp.int32)) // 2  # non-negative → trunc ok
    rg = r.astype(jnp.int32) - avg
    bg = b.astype(jnp.int32) - avg

    # window elements x-25..x+24: the reference's left scan is inclusive of
    # x-strength (xl >= x-strength, then xl--) while the right scan stops at
    # x+strength-1 (xr < x+strength) — patternnoise.c:123-144
    offs = list(range(-_STRENGTH, _STRENGTH))
    # validity: prefix-AND of |avg[x+k]-avg[x]| <= thr moving away from x;
    # out-of-row elements get a huge fill so the condition breaks at borders
    diff_ok = []
    for d in offs:
        shifted = _shift_cols(avg, d, fill=10**9)
        diff_ok.append(jnp.abs(shifted - avg) <= _THR)
    diff_ok = jnp.stack(diff_ok)  # (50, h, w), center at index STRENGTH

    c = _STRENGTH
    valid = diff_ok.at[c].set(jnp.ones_like(diff_ok[c]))
    # cumulative AND away from the center
    right = jnp.cumprod(valid[c + 1 :].astype(jnp.int32), axis=0).astype(bool)
    left = jnp.cumprod(valid[:c][::-1].astype(jnp.int32), axis=0).astype(bool)[::-1]
    window = jnp.concatenate([left, jnp.ones((1, h, w), bool), right], axis=0)

    def med(chan):
        stack = jnp.stack([_shift_cols(chan, d, fill=_SENTINEL) for d in offs])
        m, _ = _masked_median(stack, window)
        return m

    mg1 = med(g1.astype(jnp.int32))
    mg2 = med(g2.astype(jnp.int32))
    mg = (mg1 + mg2) // 2
    mrg = med(rg)
    mbg = med(bg)
    return (mrg + mg), mg1, mg2, (mbg + mg)


def _horizontal_gradient_flat(chan):
    """out[i] = in[i-2] - in[i+2] on the flattened image (patternnoise.c:78-86)."""
    flat = chan.reshape(-1).astype(jnp.int32)
    n = flat.shape[0]
    out = jnp.zeros(n, jnp.int32)
    out = out.at[2 : n - 2].set(flat[: n - 4] - flat[4:])
    return out.reshape(chan.shape)


def _fix_column_noise(original, denoised, white):
    """Column median offsets from the noise image (patternnoise.c:185-282)."""
    noise = original - denoised
    hgrad = jnp.abs(_horizontal_gradient_flat(original))
    masked = (hgrad > 500) | (original >= white)

    med, num = _masked_median(noise, ~masked, axis=0)  # per column
    offsets = jnp.where(num < 10, 0, -med)

    applied = jnp.clip(original + offsets[None, :], -32767, 32767)
    # remove the median offset to prevent a global cast
    w = offsets.shape[0]
    mc = jnp.sort(offsets)[(w // 2) if (w % 2) else (w // 2 - 1)]
    return jnp.clip(applied - mc, 0, 32760)


def _fix_column_noise_rggb(raw, white):
    """One direction over the full Bayer frame (patternnoise.c:312-355)."""
    r = raw[0::2, 0::2]
    g1 = raw[0::2, 1::2]
    g2 = raw[1::2, 0::2]
    b = raw[1::2, 1::2]
    rs, g1s, g2s, bs = _edge_aware_blur(r, g1, g2, b)
    r2 = _fix_column_noise(r.astype(jnp.int32), rs, white)
    g1f = _fix_column_noise(g1.astype(jnp.int32), g1s, white)
    g2f = _fix_column_noise(g2.astype(jnp.int32), g2s, white)
    b2 = _fix_column_noise(b.astype(jnp.int32), bs, white)
    # reassemble by pure reshape interleaves (strided scatters are slow)
    h2, w2 = r2.shape
    top = jnp.stack([r2, g1f], axis=-1).reshape(h2, 2 * w2)
    bot = jnp.stack([g2f, b2], axis=-1).reshape(h2, 2 * w2)
    out = jnp.stack([top, bot], axis=1).reshape(2 * h2, 2 * w2)
    return out.astype(raw.dtype)


def fix_pattern_noise_image(img: jnp.ndarray, white: int) -> jnp.ndarray:
    """Full pattern-noise fix on one frame (int16 semantics, uint16 storage).

    Odd frame dimensions (real: EOSM crop mode records 1808x727) process
    the even-cropped region and pass the last row/column through unchanged.
    The reference has no defined behavior to match here: its channel
    buffers are w/2*h/2 but extract_channel writes ceil(h/2) rows — a heap
    overflow for odd sizes (patternnoise.c:287-296 vs :315-328)."""
    h, w = img.shape
    he, we = h & ~1, w & ~1
    if (he, we) != (h, w):
        if he == 0 or we == 0:
            return img
        core = fix_pattern_noise_image(img[:he, :we], white)
        out = img.at[:he, :we].set(core.astype(img.dtype))
        return out
    raw = img.astype(jnp.int16).astype(jnp.int32)
    raw = _fix_column_noise_rggb(raw, white)
    raw = _fix_column_noise_rggb(raw.T, white).T
    return raw.astype(jnp.uint16)


@functools.partial(jax.jit, static_argnums=(1,))
def fix_pattern_noise_batch(imgs: jnp.ndarray, white: int) -> jnp.ndarray:
    return jax.vmap(lambda im: fix_pattern_noise_image(im, white))(imgs)
