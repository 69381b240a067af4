"""Device-side dual-ISO preview analysis (phase detection + histogram fit).

The host reference (dualiso.green_phase_histograms + fit_preview) pulls the
~0.2 MB/frame green sample grid to the host for np.bincount and the CDF
walk — a host sync in the middle of every batch. This module computes the
same fit on device (hdr.c:40-183 semantics), and is the only fit the
conversion path runs:

  * per-phase green samples are static strided slices (rows of one
    y-mod-4 phase step 20, one column parity step 4), sorted per frame;
  * histogram medians are order statistics of the sorted samples;
  * the CDF walk pairs the two exposures' cumulative counts; both
    pointers have closed forms over the SORTED samples — acc_hi at the
    next accepted bin is a run-end CDF gather, and the reference's
    persistent raw_lo pointer is an inverse-CDF gather (the smallest r
    with count(lo <= r) >= c is the c-th smallest lo sample);
  * the accept gate (advance only when >100 new hi pixels accumulated
    since the last accepted point) is the one genuinely sequential
    piece, but it is a pointer jump, not a bin scan: from accepted
    count c the next accepted bin is the sorted hi sample at rank
    c+100, so the walk is a <= total/101-step lax.scan of three small
    gathers carrying the weighted-least-squares sums (every other gate
    is monotone over bins, hence terminal);
  * the LS sums run in double-single f32 (evarith primitives): terms
    reach w*x^2 ~ 2^43 over up to ~10^3 points, far beyond f32's 24-bit
    integer range, and the a = (mxy - mx*my)/(mx2 - mx^2) denominator
    cancels heavily.

The preview parity gate (tests/test_parity_dualiso_preview.py, PSNR vs
the compiled reference) covers this path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .evarith import _ds_add, _ds_mul, _two_prod


def _phase_slices(h: int, w: int):
    """Static (row_start, col_off, n_rows, n_cols) per phase — the sample
    grid of hdr.c:47-59 (every 5th row from 4, every 4th column)."""
    ys = np.arange(4, h - 4, 5)
    specs = []
    for q in range(4):
        ys_q = ys[ys % 4 == q]
        off_q = int((ys_q[0] + 1) % 2) if len(ys_q) else 0
        # stored count uses (w - off) // 4 (hdr.c hist->count) while the
        # sample set is the full off::4 slice (ceil) — bug-compatible
        specs.append(
            (
                int(ys_q[0]) if len(ys_q) else 0,
                off_q,
                len(ys_q),
                len(ys_q) * ((w - off_q) // 4),
            )
        )
    return specs


@functools.partial(jax.jit, static_argnums=(1, 2))
def preview_fit_device(imgs, black: int, white: int):
    """Per-frame (ok, a, b, shadow, dark_row_start) on device.

    Matches dualiso.fit_preview value-for-value up to the f64→double-
    single LS arithmetic (the preview path's gate is PSNR)."""
    b, h, w = imgs.shape
    specs = _phase_slices(h, w)
    nb = white + 1
    total = specs[0][3]  # hist_total = phase-0 stored count (hdr.c:125)

    # per-phase sorted samples (padded to a common length with white+1,
    # which sorts above every bin and so never perturbs a CDF over
    # 0..white); medians are order statistics of the sorted samples
    sorted_ph = []
    medians = []
    real_counts = []
    for q in range(4):
        y0, off, nr, cnt = specs[q]
        sl = imgs[:, y0 : y0 + 20 * nr : 20, off :: 4]
        sl = jnp.minimum(sl.astype(jnp.int32), white).reshape(b, -1)
        srt = jnp.sort(sl, axis=1)
        real_counts.append(srt.shape[1])
        sorted_ph.append(srt)
        # hist_median: first bin with cum > count//2 == sorted[count//2]
        # (the CDF counts every slice sample; cnt is the stored count)
        medians.append(srt[:, min(cnt // 2, srt.shape[1] - 1)])

    L = max(real_counts)
    sorted_pad = jnp.stack(
        [
            jnp.concatenate(
                [sp, jnp.full((b, L - sp.shape[1]), white + 1, jnp.int32)], axis=1
            )
            for sp in sorted_ph
        ],
        axis=1,
    )  # (B, 4, L)

    med = jnp.stack(medians, axis=1) - black  # (B, 4)

    # detect_phase (hdr.c:66-107), first matching case wins
    m0, m1, m2, m3 = med[:, 0], med[:, 1], med[:, 2], med[:, 3]
    c0 = (m2 > 2 * m0) & (m2 > 2 * m1) & (m3 > 2 * m0) & (m3 > 2 * m1)
    c1 = (m0 > 2 * m1) & (m0 > 2 * m2) & (m3 > 2 * m1) & (m3 > 2 * m2)
    c2 = (m0 > 2 * m2) & (m0 > 2 * m3) & (m1 > 2 * m2) & (m1 > 2 * m3)
    c3 = (m1 > 2 * m0) & (m1 > 2 * m3) & (m2 > 2 * m0) & (m2 > 2 * m3)
    drs = jnp.where(c0, 0, jnp.where(c1, 1, jnp.where(c2, 2, jnp.where(c3, 3, -1))))
    qlo = jnp.where(c0, 0, jnp.where(c1, 1, jnp.where(c2, 2, jnp.where(c3, 0, 0))))
    qhi = jnp.where(c0, 2, jnp.where(c1, 0, jnp.where(c2, 0, jnp.where(c3, 2, 0))))
    phase_ok = drs >= 0

    sel_hi = (jnp.arange(4)[None, :] == qhi[:, None]).astype(jnp.int32)
    sel_lo = (jnp.arange(4)[None, :] == qlo[:, None]).astype(jnp.int32)
    hi_samples = (sorted_pad * sel_hi[:, :, None]).sum(axis=1)  # (B, L) sorted
    lo_sorted = (sorted_pad * sel_lo[:, :, None]).sum(axis=1)
    counts_arr = jnp.asarray(real_counts, jnp.int32)
    n_lo = (counts_arr[None, :] * sel_lo).sum(axis=1)  # (B,)

    # The reference's bin walk visits every raw value 0..total-1, but a bin
    # is accepted only when acc_hi grew by > min_pix since the last accept —
    # and acc_hi is the CDF of the sorted hi samples, so the next accepted
    # bin is a POINTER JUMP into the sorted samples: from last accepted
    # count c, the first bin with acc_hi > c+min_pix is the value of the
    # sorted sample at rank c+min_pix. Every other accept gate is terminal
    # (acc_hi, raw_lo, and the bin value are all monotone over bins), so the
    # walk is <= total/(min_pix+1)+2 steps of 3 small gathers — it replaces
    # a 15001-step lax.scan plus eight materialized (B, white+1) arrays
    # (scatter-hist, cumsum, inverse-CDF gather), and accumulates the exact
    # same ds sums in the same order (skipped bins contributed exact zero
    # adds). Accepted set and fp results are bit-identical by construction.

    # run-end CDF per sorted hi sample: cdf_at[i] = #real samples <= s[i]
    # (pads at white+1 sort above every real sample; a pad candidate fails
    # the bin < nb gate, so pads never contribute)
    nxt = jnp.concatenate(
        [hi_samples[:, 1:], jnp.full((b, 1), white + 2, jnp.int32)], axis=1
    )
    pos1 = jnp.where(
        nxt != hi_samples, jnp.arange(1, L + 1, dtype=jnp.int32)[None, :], L + 1
    )
    cdf_at = jax.lax.cummin(pos1, axis=1, reverse=True)  # (B, L)

    min_pix = 100
    lo_gate = total * 1 // 100
    hi_gate_num = int(total * 9999)  # acc_hi < total*99.99/100 ⇔ 10000*acc_hi < 9999*total

    zero = jnp.zeros((b,), jnp.float32)
    rows = jnp.arange(b)

    def body(carry, _):
        c, done, n, sums = carry
        # first bin with acc_hi > max(c + min_pix, lo_gate): the sorted
        # sample at that rank (rank >= L means no such bin exists)
        rank = jnp.maximum(c + min_pix, lo_gate)
        rank_c = jnp.minimum(rank, L - 1)
        bin_v = hi_samples[rows, rank_c]
        acc = cdf_at[rows, rank_c]
        # raw_lo at this bin: inverse CDF of the lo samples (closed form)
        lo_idx = jnp.clip(acc - 1, 0, L - 1)
        inv = lo_sorted[rows, lo_idx] + 1
        raw_lo_v = jnp.where(acc > n_lo, nb, jnp.minimum(inv, nb))
        accept = (
            ~done
            & (rank < L)                      # un-clamped: diff > min_pix holds
            & (bin_v < total)                 # reference loop bound (raw value!)
            & (bin_v < nb)                    # real sample, inside the bin range
            & (acc * 10000 < hi_gate_num)
            & (raw_lo_v < white)
        )
        x_v = (bin_v - black).astype(jnp.float32)
        y_v = (raw_lo_v - black).astype(jnp.float32)
        wt_v = jnp.maximum(bin_v - black + 100, 0).astype(jnp.float32)
        af = accept.astype(jnp.float32)
        wte = wt_v * af  # exact: wt_v is an exact f32 integer, af in {0,1}
        # exact ds products of the (integer-valued) terms
        wx_h, wx_l = _two_prod(wte, x_v)
        wy_h, wy_l = _two_prod(wte, y_v)
        wxy_h, wxy_l = _ds_mul(wx_h, wx_l, y_v, zero)
        wx2_h, wx2_l = _ds_mul(wx_h, wx_l, x_v, zero)
        (sw_h, sw_l), (sx_h, sx_l), (sy_h, sy_l), (sxy_h, sxy_l), (sx2_h, sx2_l) = sums
        sums = (
            _ds_add(sw_h, sw_l, wte, zero),
            _ds_add(sx_h, sx_l, wx_h, wx_l),
            _ds_add(sy_h, sy_l, wy_h, wy_l),
            _ds_add(sxy_h, sxy_l, wxy_h, wxy_l),
            _ds_add(sx2_h, sx2_l, wx2_h, wx2_l),
        )
        c = jnp.where(accept, acc, c)
        done = done | ~accept  # every rejection is terminal (monotone gates)
        n = n + accept.astype(jnp.int32)
        return (c, done, n, sums), None

    init = (
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), jnp.bool_),
        jnp.zeros((b,), jnp.int32),
        tuple((zero, zero) for _ in range(5)),
    )
    n_steps = max(2, total // (min_pix + 1) + 2)
    (_, _, n, sums), _ = jax.lax.scan(body, init, None, length=n_steps, unroll=8)

    (sw_h, sw_l), (sx_h, sx_l), (sy_h, sy_l), (sxy_h, sxy_l), (sx2_h, sx2_l) = sums
    # weighted LS entirely in ds: a = (W*Sxy - Sx*Sy) / (W*Sx2 - Sx^2) —
    # the denominator cancels heavily (mx2 ~ mx^2), so f32 means would
    # cost ~4 digits of the fitted gain
    num_h, num_l = _ds_add(
        *_ds_mul(sw_h, sw_l, sxy_h, sxy_l),
        *(lambda hh, ll: (-hh, -ll))(*_ds_mul(sx_h, sx_l, sy_h, sy_l)),
    )
    den_h, den_l = _ds_add(
        *_ds_mul(sw_h, sw_l, sx2_h, sx2_l),
        *(lambda hh, ll: (-hh, -ll))(*_ds_mul(sx_h, sx_l, sx_h, sx_l)),
    )
    den = den_h + den_l
    a_fit = jnp.where(jnp.abs(den) > 0, (num_h + num_l) / den, 1.0)
    # b = (Sy - a*Sx) / W
    b_fit = ((sy_h + sy_l) - a_fit * (sx_h + sx_l)) / jnp.maximum(sw_h, 1.0)
    few = n < 2  # reference falls back to a neutral gain (hdr.c note)
    a_out = jnp.where(few, 1.0, a_fit)
    b_out = jnp.where(few, 0.0, b_fit)
    shadow_f = black + 1.0 / jnp.maximum(a_out * a_out, 1e-12) + b_out
    shadow = (jnp.trunc(shadow_f).astype(jnp.int32) & 0xFFFF)
    shadow = jnp.where(few, 0, shadow)
    return phase_ok, a_out, b_out, shadow, jnp.maximum(drs, 0)
