"""Device-side dual-ISO analysis (the fast path).

Same stages as dualiso_analysis.py (hdr.c:441-823) expressed as batched
device reductions, so the frames never leave HBM: only per-frame scalars
(pattern flags, white levels, fitted gain/offset) are pulled to host. The
RANSAC inlier scoring runs in f32 on device; the exact-LUT mode keeps the
f64 host implementation for strict parity work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnums=(1,))
def rggb_stat(img, active_y1: int = 0):
    """diffs_rggb < diffs_gbrg (identify_rggb_or_gbrg, hdr.c:441-495).

    The L1 distance between the count-CDFs of two equal-size samples equals
    the sum of |order statistic differences| — so the comparison needs four
    static channel slices and four sorts, no histograms.
    """
    h, w = img.shape
    y0 = (active_y1 + 3) & ~3
    region = img[y0 : h // 4 * 4].astype(jnp.int32) & 16383
    ch = {}
    for py in range(2):
        for px in range(2):
            ch[py * 2 + px] = jnp.sort(region[py::2, px::2].reshape(-1))
    diffs_rggb = jnp.abs(ch[1] - ch[2]).sum()
    diffs_gbrg = jnp.abs(ch[0] - ch[3]).sum()
    return diffs_rggb < diffs_gbrg


@functools.partial(jax.jit, static_argnums=(1, 2))
def fields_stat_batch(imgs, black: int, active_y1: int = 0):
    """is_bright flags + ok per frame (identify_bright_and_dark_fields,
    hdr.c:497-636), histogram walks replaced by order statistics:
    raw_at(ref) = sorted[ref-1] + 1 and cum[v] = searchsorted(sorted, v)."""
    white = 10000
    b, h, w = imgs.shape
    y0 = (active_y1 + 3) & ~3
    h4 = h // 4 * 4
    hr = h4 - y0

    # The per-phase sample set (rows y0+q::4, green column parity) is NEVER
    # gathered: the strided 4-phase gather alone measured ~2.0 ms/frame at
    # 1080p (the bisection on the gathered stack was ~0.4). Every statistic
    # this stage needs is a phase-bucketed COUNT, so each bisection pass
    # compares the frame in place against a per-row threshold, masks the
    # green checkerboard, reduces rows, and buckets row sums by y%4 — a
    # fused read of the (B, hr, w) u16 region per pass, no relayout.
    region = imgs[:, y0:h4, :] & jnp.uint16(16383)
    ys = np.arange(y0, h4)
    phase_of_row = jnp.asarray(ys % 4)  # == tile([0,1,2,3]): y0 % 4 == 0
    green = jnp.asarray(((np.arange(w)[None, :] ^ ys[:, None]) & 1) == 1)
    n = (hr // 4) * (w // 2)  # per-phase sample count (identical by constr.)
    hist_total = n

    def counts(mid):
        """#green-phase-q samples <= mid[..., q] — mid is (B, K, 4) int32,
        returns (B, K, 4) int32. One in-place pass over the region."""
        m16 = jnp.clip(mid, 0, 16383).astype(jnp.uint16)  # mid <= 16383 here
        mrow = m16[:, :, phase_of_row]  # (B, K, hr)
        le = (region[:, None] <= mrow[:, :, :, None]) & green[None, None]
        per_row = le.sum(axis=3, dtype=jnp.int32)  # (B, K, hr)
        return per_row.reshape(b, -1, hr // 4, 4).sum(axis=2)

    ref_max = int(hist_total * 0.998)
    ref_off = int(hist_total * 0.05)
    thr = black + (white - black) // 4
    # cum[white-2] and cum[thr-2] per phase: one fused two-threshold pass
    fixed = jnp.broadcast_to(
        jnp.asarray([white - 2, max(thr - 2, 0)], jnp.int32)[None, :, None], (b, 2, 4)
    )
    cum = counts(fixed)
    first_break = cum[:, 0].min(axis=1) + 1
    ref_final = jnp.minimum(ref_max - 1, first_break).astype(jnp.int32)  # (B,)
    cond_bound = cum[:, 1].min(axis=1).astype(jnp.int32)
    ref_b = jnp.minimum(jnp.minimum(ref_off - 1, cond_bound), ref_final)

    # (ref-1)-th order statistic per phase for BOTH refs in one vectorized
    # value-range bisection (15 in-place passes; exact for integers)
    ref2 = jnp.stack([ref_b, ref_final], axis=1)[:, :, None]  # (B, 2, 1)
    k = jnp.clip(jnp.broadcast_to(ref2, (b, 2, 4)) - 1, 0, n - 1)
    lo = jnp.zeros((b, 2, 4), jnp.int32)
    hi = jnp.full((b, 2, 4), 16384, jnp.int32)
    for _ in range(15):  # interval 16385 -> 1
        mid = (lo + hi) >> 1
        cnt = counts(mid)
        take = cnt >= k + 1
        hi = jnp.where(take, mid, hi)
        lo = jnp.where(take, lo, mid + 1)
    stat2 = jnp.where(ref2 <= 0, 0, lo + 1)  # (B, 2, 4)

    off = jnp.where(ref_b[:, None] >= 0, stat2[:, 0], 0)
    raw = stat2[:, 1] - off  # (B, 4)
    srt = jnp.sort(raw, axis=1)
    median_bright = (srt[:, 1] + srt[:, 2]).astype(jnp.float32) / 2
    is_bright = raw.astype(jnp.float32) > median_bright[:, None]
    ok = (
        (is_bright.sum(axis=1) == 2)
        & (is_bright[:, 0] != is_bright[:, 2])
        & (is_bright[:, 1] != is_bright[:, 3])
        & (ref_final >= 0)
    )
    return ok, is_bright


@functools.partial(jax.jit, static_argnums=(2, 3))
def white_detect_batch(imgs, is_bright, active_area, max_pix: int):
    """(white_dark, white_bright) per frame (white_detect, hdr.c:250-300)."""
    y1, x1, y2, x2 = active_area
    discard = (10, 50)
    margins = (100, 1500)

    def one(img, ib):
        ys = np.arange(y1, y2, 3)
        grid = img[y1:y2:3, x1:x2:3].astype(jnp.int32)  # slice, not gather
        bright_rows = ib[ys % 4]
        whites = []
        for bin_idx in range(2):
            m = jnp.broadcast_to((bright_rows == bool(bin_idx))[:, None], grid.shape)
            sel = jnp.where(m, grid, -1).reshape(-1)
            # replicate the sample-buffer clamp: keep the first max_pix-1
            # samples and the last one (hdr.c:278-281)
            order = jnp.cumsum(jnp.where(m, 1, 0).reshape(-1))
            count = order[-1]
            keep = (sel >= 0) & ((order <= max_pix - 1) | (order == count))
            vals = jnp.where(keep, sel, -1)
            k = jnp.minimum(discard[bin_idx], jnp.maximum(jnp.minimum(count, max_pix) - 1, 0))
            # k-th largest (0-indexed) = smallest v with count(vals > v) <= k;
            # 15-pass value bisection in place of the descending full sort.
            # Invariant: over(hi) <= k, over(lo) > k (lo = -2 is a virtual
            # always-invalid boundary; -1 is a reachable value: the fills).
            lo = jnp.full((), -2, jnp.int32)
            hi = jnp.full((), 16383, jnp.int32)
            for _ in range(16):  # interval 16386 -> 1 needs 15; one spare
                mid = (lo + hi) >> 1
                ok_mid = (vals > mid).sum() <= k
                hi = jnp.where(ok_mid, mid, hi)
                lo = jnp.where(ok_mid, lo, mid)
            whites.append(hi - margins[bin_idx])
        wd = jnp.clip(whites[0], 10000, 16383)
        wb = jnp.clip(whites[1], 5000, 16383)
        return wd, wb

    return jax.vmap(one)(imgs, is_bright)


def _tdiv(a, b):
    q = jnp.abs(a) // b
    return jnp.where(a < 0, -q, q)


@functools.partial(jax.jit, static_argnums=(4, 5))
def match_exposures_batch(imgs, is_bright, black20s, white20s, shape, active_y1: int = 0):
    """Exposure fit per frame (match_exposures, hdr.c:638-823), f32 scoring.

    black20s/white20s: per-frame (B,) int32 (white from white_detect).
    Returns (ok, a, b, white_darkened) arrays.
    """
    h, w = shape
    y0 = active_y1 + 2
    ys = np.arange(y0, h - 2, 3)
    xs = np.arange(0, w, 3)
    hi_nmax = ((w + 2) * (h + 2) // 9) // 50

    def one(img, ib, black20, white20):
        black = black20 // 16
        white = white20 // 16
        clip0 = white - black
        clip = (clip0.astype(jnp.float32) * 0.95).astype(jnp.int32)

        p16 = img.astype(jnp.int32) << 2
        # strided basic slices, NOT np.ix_ advanced indexing: the latter
        # lowers to a gather (measured ~1 ms/frame at 1080p for the three
        # 3x3-downsample reads); a slice is a cheap strided copy
        pn = p16[y0 : h - 2 : 3, 0 : w : 3] - black
        pa = p16[y0 - 2 : h - 4 : 3, 0 : w : 3] - black
        pb = p16[y0 + 2 : h : 3, 0 : w : 3] - black
        pi = _tdiv(pa + pb + 1, 2)
        pi = jnp.where((pa >= clip) | (pb >= clip), clip0, pi)
        pn = jnp.where(pi >= clip, clip0, pn)

        row_bright = ib[ys % 4]
        bright = jnp.where(row_bright[:, None], pn, pi).reshape(-1)
        dark = jnp.where(row_bright[:, None], pi, pn).reshape(-1)

        unclipped = bright < clip
        n = unclipped.sum()
        big = 1 << 30
        # ONE two-operand sort (darks ride along) supplies every order
        # statistic AND the highlight selection: the selected pairs
        # (b_lo < bright < b_hi) are a CONTIGUOUS window of the
        # bright-sorted order, so the 230k-element cumsum+scatter
        # compaction this replaces (scatters serialize per element)
        # becomes a dynamic slice. The RANSAC score is a sum
        # over the selected pair SET, so pair order is irrelevant; the
        # hi_nmax cap binds on a different subset than the raster-order
        # reference cap only when >hi_nmax pixels are selected (PSNR-gated
        # path).
        bs, dcarry = jax.lax.sort((jnp.where(unclipped, bright, big), dark), num_keys=1)

        def wirth_k(nn):
            return jnp.where((nn & 1) == 1, nn // 2, nn // 2 - 1)

        bmed = bs[jnp.clip(wirth_k(n), 0, bs.shape[0] - 1)]
        k98 = jnp.clip(n * 98 // 100, 0, bs.shape[0] - 1)
        b_lo = bs[k98]
        k999 = jnp.clip((n.astype(jnp.float32) * 0.999).astype(jnp.int32), 0, bs.shape[0] - 1)
        b_hi = bs[k999]
        # median of the unclipped darks: value-range bisection (exact);
        # materialize the masked stack once so the strided-gather chain
        # behind dark/unclipped is not re-fused into all 20 passes
        dm = jax.lax.optimization_barrier(jnp.where(unclipped, dark, big))
        kd = jnp.clip(wirth_k(n), 0, dm.shape[0] - 1)
        dlo = jnp.full((), -(1 << 18), jnp.int32)
        dhi = jnp.full((), 1 << 18, jnp.int32)
        for _ in range(20):  # interval 2^19+1 -> 1
            dmid = (dlo + dhi) >> 1
            cnt = (dm <= dmid).sum()
            take = cnt >= kd + 1
            dhi = jnp.where(take, dmid, dhi)
            dlo = jnp.where(take, dlo, dmid + 1)
        dmed = dlo

        start = (bs <= b_lo).sum()  # first sorted index with bright > b_lo
        bs_pad = jnp.concatenate([bs, jnp.full(hi_nmax, big, bs.dtype)])
        dc_pad = jnp.concatenate([dcarry, jnp.zeros(hi_nmax, dcarry.dtype)])
        hb_w = jax.lax.dynamic_slice(bs_pad, (start,), (hi_nmax,))
        hd_w = jax.lax.dynamic_slice(dc_pad, (start,), (hi_nmax,))
        valid = hb_w < b_hi  # window starts past b_lo; big pads fail this
        hb = jnp.where(valid, hb_w, 0).astype(jnp.float32)
        hd = jnp.where(valid, hd_w, 0).astype(jnp.float32)

        evs = jnp.arange(3000, dtype=jnp.float32) * 0.002
        a_cand = jnp.exp2(-evs)
        b_cand = dmed.astype(jnp.float32) - bmed.astype(jnp.float32) * a_cand
        e = hd[None, :] - (hb[None, :] * a_cand[:, None] + b_cand[:, None])
        inlier = (jnp.abs(jnp.trunc(e)) < 50) & valid[None, :]
        scores = inlier.sum(axis=1)
        best = jnp.argmax(scores)
        a = a_cand[best]
        b = b_cand[best]
        ok = (scores[best] > 0) & (1 / a >= 1.2)
        b20 = b * 16
        wd = ((white20 - black20).astype(jnp.float32) + b20) * a + black20
        return ok, a, b, wd.astype(jnp.int32)

    return jax.vmap(one)(imgs, is_bright, black20s, white20s)
