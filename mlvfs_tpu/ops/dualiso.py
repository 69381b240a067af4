"""Dual-ISO: fast preview path (--dual-iso-preview).

The sensor alternates ISO every two rows; the preview reconstruction
(hdr_convert_data, hdr.c:40-227):

  1. green-channel histograms per row-phase (y mod 4), sampled every 5th row
     and every 4th column;
  2. phase detection: which pair of row phases is the dark exposure;
  3. focus-pixel fix (horizontal interpolation);
  4. histogram matching: walk both CDFs to sample the dark=f(bright) curve,
     weighted least squares → gain a, offset b;
  5. per-row transform: darken bright rows into the dark exposure's scale
     (overexposed pixels replaced by the neighboring dark rows), lift dark
     shadows by blending with scaled bright neighbors;
  6. shift to 16-bit (<<2), black/white ×4, matching full cr2hdr output.

Device split: the fit (ops/dualiso_preview_dev.py) and the row transform run
on device (the transform is a lax.scan over rows because the reference reads
*already-transformed* rows two above — an exact sequential dependency). The
host f64 fit below (histograms, CDF walk, 2-parameter fit) is the reference
the device fit is tested against.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class PreviewFit:
    ok: bool = False
    dark_row_start: int = 0
    a: float = 1.0
    b: float = 0.0
    shadow: int = 0


# ---------------------------------------------------------------- histograms


def green_phase_histograms(imgs: jnp.ndarray, white: int):
    """(B, 4, white+1) histograms + (4,) stored counts (hdr.c:47-59).

    The sampling grid is fully static (every 5th row; within a phase all
    rows share one column offset since ys % 4 fixes ys % 2), so the device
    side is four strided slices; the histograms are np.bincount over the
    pulled samples — the fit consumes them on the host anyway, and device
    scatter-adds were ~14 ms/frame at 1080p for this stage alone. Sample
    set and stored counts match the previous device formulation exactly.
    """
    b, h, w = imgs.shape
    ys = np.arange(4, h - 4, 5)
    offs = (ys + 1) % 2
    phase = ys % 4  # which histogram each row feeds

    sample_sets = []
    counts = np.zeros(4, np.int64)
    for q in range(4):
        ys_q = ys[phase == q]
        off_q = int(offs[phase == q][0]) if len(ys_q) else 0
        rows = imgs[:, jnp.asarray(ys_q), :] if len(ys_q) else imgs[:, :0, :]
        sample_sets.append(rows[:, :, off_q::4])
        # reference count semantics: (w - off) // 4 per row (hist->count)
        counts[q] = len(ys_q) * ((w - off_q) // 4)

    host = jax.device_get(sample_sets)
    hists = np.zeros((b, 4, white + 1), np.int32)
    for q in range(4):
        if host[q].size == 0:
            continue
        v = np.minimum(host[q].astype(np.int64), white).reshape(b, -1)
        for bi in range(b):
            hists[bi, q] = np.bincount(v[bi], minlength=white + 1)
    return hists, counts


def _hist_median(hist: np.ndarray, count: int) -> int:
    """hist_median (histogram.c:64-75): first bin where cumsum > count/2."""
    cum = np.cumsum(hist)
    idx = np.nonzero(cum > count // 2)[0]
    return int(idx[0]) if len(idx) else 0


# ------------------------------------------------------------- host-side fit


def detect_phase(medians, black: int):
    """Dark-row phase from the 4 medians (hdr.c:66-107). Returns -1 if none."""
    m = [int(v) - black for v in medians]
    if m[2] > 2 * m[0] and m[2] > 2 * m[1] and m[3] > 2 * m[0] and m[3] > 2 * m[1]:
        return 0, 0, 2  # dark_row_start, lo phase, hi phase
    if m[0] > 2 * m[1] and m[0] > 2 * m[2] and m[3] > 2 * m[1] and m[3] > 2 * m[2]:
        return 1, 1, 0
    if m[0] > 2 * m[2] and m[0] > 2 * m[3] and m[1] > 2 * m[2] and m[1] > 2 * m[3]:
        return 2, 2, 0
    if m[1] > 2 * m[0] and m[1] > 2 * m[3] and m[2] > 2 * m[0] and m[2] > 2 * m[3]:
        return 3, 0, 2
    return -1, 0, 0


def match_histograms(hist_hi, hist_lo, count_total, black: int, white: int) -> PreviewFit:
    """CDF walk + weighted least squares (hdr.c:111-183)."""
    min_pix = 100
    acc_lo = 0
    acc_hi = 0
    raw_lo = 0
    prev_acc_hi = 0
    xs, ys, ws = [], [], []
    hi = np.asarray(hist_hi, np.int64)
    lo = np.asarray(hist_lo, np.int64)
    total = int(count_total)
    lo_hi_bound = len(lo)
    for raw_hi in range(total):
        if raw_hi >= len(hi):
            break
        acc_hi += int(hi[raw_hi])
        while acc_lo < acc_hi and raw_lo < lo_hi_bound:
            acc_lo += int(lo[raw_lo])
            raw_lo += 1
        if raw_lo >= white:
            break
        if acc_hi - prev_acc_hi > min_pix:
            if acc_hi > total * 1 // 100 and acc_hi < total * 99.99 / 100:
                xs.append(raw_hi - black)
                ys.append(raw_lo - black)
                ws.append(max(0, raw_hi - black + 100))
                prev_acc_hi = acc_hi
    if len(xs) < 2:
        # the reference computes a NaN fit and converts anyway (hdr.c never
        # checks data_num); we fall back to a neutral gain instead of NaN
        return PreviewFit(ok=True, a=1.0, b=0.0, shadow=0)
    x = np.asarray(xs, np.float64)
    y = np.asarray(ys, np.float64)
    wt = np.asarray(ws, np.float64)
    weight = wt.sum()
    mx = (x * wt).sum() / weight
    my = (y * wt).sum() / weight
    mxy = (x * y * wt).sum() / weight
    mx2 = (x * x * wt).sum() / weight
    a = (mxy - mx * my) / (mx2 - mx * mx)
    b = my - a * mx
    shadow = int(black + 1 / (a * a) + b) & 0xFFFF
    return PreviewFit(ok=True, a=float(a), b=float(b), shadow=shadow)


def fit_preview(hists, counts, black: int, white: int) -> list:
    """Per-frame fits from device histograms. hists: (B, 4, white+1) np."""
    out = []
    for fr in range(hists.shape[0]):
        med = [_hist_median(hists[fr, q], counts[q]) for q in range(4)]
        drs, qlo, qhi = detect_phase(med, black)
        if drs < 0:
            out.append(PreviewFit(ok=False))
            continue
        # hist_total is hist[0]->count regardless of phase (hdr.c:125)
        fit = match_histograms(hists[fr, qhi], hists[fr, qlo], counts[0], black, white)
        fit.dark_row_start = drs
        out.append(fit)
    return out


# -------------------------------------------------------- device-side apply


@functools.partial(jax.jit, static_argnums=(5, 6))
def apply_preview_xla(imgs, a, b, shadow, dark_row_start, black: int, white: int):
    """Row transform + 16-bit shift (hdr.c:185-224), exact row ordering.

    Rows are processed top to bottom; a row may read the already-transformed
    row two above (hdr.c:195,210) — expressed as a lax.scan carrying the last
    two output rows. Per-frame scalars (a, b, shadow, phase) are traced.
    """
    bsz, h, w = imgs.shape
    src = imgs.astype(jnp.float32)
    a = a.astype(jnp.float32)[:, None]
    b_ = b.astype(jnp.float32)[:, None]
    shadow_f = shadow.astype(jnp.float32)[:, None]
    drs = dark_row_start.astype(jnp.int32)
    blackf = jnp.float32(black)
    whitef = jnp.float32(white)

    def scale(p):
        return jnp.minimum(whitef, (p - blackf) * a + blackf + b_)

    def step(carry, y):
        prev2, prev1 = carry  # transformed rows y-2, y-1
        row = src[:, y, :]
        below = src[:, jnp.minimum(y + 2, h - 1), :]
        up_ok = y > 2
        down_ok = y < h - 2

        is_bright = ((y - drs + 4) % 4) >= 2  # (B,)

        # bright row (hdr.c:190-201)
        over = row >= whitef
        repl = jnp.where(
            up_ok,
            jnp.where(down_ok, jnp.trunc((prev2 + below) / 2), prev2),
            below,
        )
        bright_out = jnp.where(over, jnp.trunc(repl), jnp.trunc(scale(row)))

        # dark row (hdr.c:203-214)
        in_shadow = row < shadow_f
        scaled_below = scale(below)
        dark_repl = jnp.where(
            up_ok,
            jnp.where(down_ok, jnp.trunc((prev2 + scaled_below) / 2), prev2),
            jnp.trunc(scaled_below),
        )
        dark_out = jnp.where(in_shadow, jnp.trunc(dark_repl), row)

        out = jnp.where(is_bright[:, None], bright_out, dark_out)
        out = jnp.clip(out, 0, 65535)
        return (prev1, out), out

    init = (src[:, 0, :], src[:, 0, :])
    _, rows = jax.lax.scan(step, init, jnp.arange(h))
    out = jnp.swapaxes(rows, 0, 1)  # (B, h, w)
    return (out.astype(jnp.uint16) << 2).astype(jnp.uint16)


# ------------------------------------------------------------- orchestrator


def hdr_preview_batch(imgs, fh, cal):
    """Full preview path for a batch. Returns (imgs, ok_mask array).

    The phase detection + histogram fit run on device
    (ops/dualiso_preview_dev.py) so the batch never visits the host mid-way;
    the host f64 fit (green_phase_histograms + fit_preview) is kept as the
    tests' reference for it."""
    ri = fh.raw_info
    black, white = ri.black_level, ri.white_level

    from . import dualiso_preview_dev as pdev

    ok, a, bb, shadow, drs = pdev.preview_fit_device(imgs, black, white)

    # focus pixels fixed inside the preview path, horizontal mode — but only
    # on frames whose interlacing was detected: the reference returns before
    # fix_focus_pixels when detection fails (hdr.c:104-109), leaving the
    # frame for the caller's else-branch (normal-mode fixes, main.c:966-973)
    if cal is not None and cal.focus_pixel_list is not None and len(cal.focus_pixel_list):
        from . import pixels as pixel_ops

        crop_x = (int(fh.vidf["panPosX"]) + 7) & ~7
        crop_y = int(fh.vidf["panPosY"]) & ~1
        fixed = pixel_ops.fix_pixel_list_batch(
            imgs, cal.focus_pixel_list, black, crop_x, crop_y, dual_iso=True
        )
        # device-side select keeps the no-host-round-trip property of the
        # preview chain
        imgs = jnp.where(ok[:, None, None], fixed, imgs)

    converted = apply_preview_xla(imgs, a, bb, shadow, drs, black, white)
    return jnp.where(ok[:, None, None], converted, imgs), ok
