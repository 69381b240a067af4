"""Dense histograms and CDF medians on device.

Device equivalents of histogram.c: the reference builds uint16 histograms
with a stride/skip and walks the CDF for the median (hist_add/hist_median,
histogram.c:52-75). On the device these become bincount (scatter-add) +
cumsum + comparison — batched over frames.
"""

from __future__ import annotations

import jax.numpy as jnp


def hist_counts(values: jnp.ndarray, white: int) -> jnp.ndarray:
    """Histogram with bins [0..white]; values above white clamp into the last
    bin (hist_add: data[MIN(white, v)]++)."""
    v = jnp.minimum(values.astype(jnp.int32), white)
    return jnp.zeros(white + 1, jnp.int32).at[v.reshape(-1)].add(1)


def cdf_median(hist: jnp.ndarray, count: jnp.ndarray) -> jnp.ndarray:
    """First bin index where the running total exceeds count/2
    (hist_median, histogram.c:64-75). Returns 0 when nothing exceeds."""
    cum = jnp.cumsum(hist)
    middle = count // 2
    hit = cum > middle
    idx = jnp.argmax(hit)
    return jnp.where(hit.any(), idx, 0).astype(jnp.int32)


def deflicker_median(img: jnp.ndarray, white: int) -> jnp.ndarray:
    """Median used by deflicker (main.c:895-906).

    The reference feeds every second 16-bit value starting at element 1 (the
    odd-indexed pixels) and stores count = (2*H*W - 1) / 2 / 2 elements.

    Computed by value-range bisection instead of a scatter-add histogram +
    CDF walk: the answer is the smallest bin m with count(v <= m) > count/2,
    found in ~15 compare+reduce passes — identical result, and no
    scatter-adds, which serialize on colliding bins.
    """
    import math

    import jax

    hw = img.size
    s = (2 * hw - 1) // 2  # hist_add 'size' argument
    n_added = (s + 1) // 2
    if img.ndim == 2 and img.shape[1] % 2 == 0 and n_added == hw // 2:
        # even-width frames: the odd-indexed flat elements are exactly the
        # odd columns — count through a parity mask instead of a strided
        # odd-index extract (the mask reads 2x the data but needs no
        # (hw/2,)-strided relayout)
        x_odd = (jax.lax.broadcasted_iota(jnp.int32, img.shape, 1) & 1) == 1
        v = jnp.minimum(img.astype(jnp.int32), white)
        def count(mid):
            return jnp.sum(jnp.where(x_odd & (v <= mid), 1, 0))
    else:
        odd = img.reshape(-1)[1::2]
        v = jnp.minimum(odd[:n_added].astype(jnp.int32), white)
        def count(mid):
            return jnp.sum(jnp.where(v <= mid, 1, 0))
    middle = jnp.asarray((s // 2) // 2, jnp.int32)  # hist->count // 2
    lo = jnp.zeros((), jnp.int32)
    hi = jnp.full((), white, jnp.int32)
    for _ in range(int(math.ceil(math.log2(white + 1)))):
        mid = (lo + hi) >> 1
        cnt = count(mid)
        take = cnt > middle
        hi = jnp.where(take, mid, hi)
        lo = jnp.where(take, lo, mid + 1)
    total = jnp.asarray(n_added, jnp.int32)
    return jnp.where(total > middle, lo, 0).astype(jnp.int32)
