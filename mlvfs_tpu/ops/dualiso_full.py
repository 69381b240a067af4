"""Dual-ISO full-quality reconstruction (--dual-iso): the cr2hdr 20-bit port.

Pipeline (cr2hdr20_convert_data → hdr_interpolate, hdr.c:1774-1957):

  hdr_check → focus/bad pixel fix → RGGB/GBRG → bright/dark fields →
  white detect → promote to 20 bit → exposure matching → interpolate the
  missing exposure per row (mean23 here; AMaZE-edge in `amaze.py`) →
  border interpolation → full-res reconstruction → half-res EV-space blend
  (+ chroma smoothing + alias map) → final blend → dither-free 16-bit out.

Split: per-frame scalar analysis runs on host (`dualiso_analysis`), the
whole per-pixel reconstruction is ONE fused jitted device program, vmapped
over the batch with traced per-frame scalars (gain, offsets, row phase
masks) so one compilation serves every frame/clip of the same geometry.

All EV-space arithmetic uses the reference's integer LUT semantics
(luts.raw2ev_lut20 / ev2raw_lut20); float stages (exposure apply, blend
curves) run in f32 — the parity gate for this path is PSNR, not bit
equality (BASELINE.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .luts import (
    EV_RESOLUTION,
    raw2ev_lut20,
    ev2raw_lut20,
    fullres_curve,
)
from .chroma_smooth import chroma_smooth_image
from . import dualiso_analysis as analysis
from . import evarith
from . import evmath

FULLRES_THR = 0.8
ALIAS_MAP_MAX = 15000
DARK_NOISE20 = 8.0 * 64  # compute_noise defaults to stdev 8 (14-bit) for MLV
                         # frames (full-frame active area → empty OB region)


# ------------------------------------------------------------------ helpers


def _tdiv(a, b):
    """C-style truncating integer division."""
    q = jnp.abs(a) // b
    return jnp.where(a < 0, -q, q)


def _shift(arr, dy, dx, fill=0):
    """out[y, x] = arr[y+dy, x+dx], constant-filled outside."""
    h, w = arr.shape
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    padded = jnp.pad(arr, ((py1, py0), (px1, px0)), constant_values=fill)
    return jax.lax.dynamic_slice(padded, (py1 + dy, px1 + dx), (h, w))


def _row_shift(arr, s, mag):
    """arr[y + s*mag, x] with per-row sign s (+1/-1)."""
    up = _shift(arr, mag, 0)
    down = _shift(arr, -mag, 0)
    return jnp.where((s == 1)[:, None], up, down)


# ------------------------------------------------------------------ checks


@functools.partial(jax.jit, static_argnums=(1, 2))
def hdr_check_batch(imgs, black: int, white: int):
    """Quick interlaced-exposure detector (hdr_check, hdr.c:407-439).

    The raw2evf table is log2(p-black)*EVR with -inf at p==black and 0
    below; computed directly instead of through a table gather.
    """

    def evf(p):
        sig = p - black
        mag = jnp.log2(jnp.maximum(sig, 1).astype(jnp.float32)) * EV_RESOLUTION
        return jnp.where(sig > 0, mag, jnp.where(sig == 0, -jnp.inf, 0.0))

    def one(img):
        p = img.astype(jnp.int32)
        p2 = _shift(p, 2, 0)
        h, w = img.shape
        yy = jax.lax.broadcasted_iota(jnp.int32, img.shape, 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, img.shape, 1)
        # iota compares, not .at[].set: a region scatter costs ~1 ms/frame
        inner = (yy >= 2) & (yy < h - 2) & (xx >= 2) & (xx < w - 2)
        valid = inner & ((p > black + 32) | (p2 > black + 32)) & (p < white) & (p2 < white)
        diff = jnp.where(valid, jnp.abs(evf(p2) - evf(p)), 0.0)
        num = valid.sum()
        return jnp.where(num > 0, diff.sum() / num, 0.0) > 0.5

    return jax.vmap(one)(imgs)


# ------------------------------------------------------- the reconstruction


def _mean23_interpolate(p, ev, ev2raw_at, row_bright, s, evw_row, h, w):
    """mean23 (mean32_interpolate, hdr.c:1231-1304) → (dark, bright)."""
    # vertical 2-tap for R/B sites, 3-tap for green sites, in EV space
    e_up2 = _shift(ev, -2, 0)
    e_dn2 = _shift(ev, 2, 0)
    e_s_xp = _row_shift(_shift(ev, 0, 1), s, 1)
    e_s_xm = _row_shift(_shift(ev, 0, -1), s, 1)
    # y - 2s: shift by -2 when s=+1, +2 when s=-1
    e_m2s = jnp.where((s == 1)[:, None], _shift(ev, -2, 0), _shift(ev, 2, 0))

    evw = evw_row[:, None]

    def mean2(a, b):
        m = _tdiv(a + b, 2)
        return jnp.where((a >= evw) | (b >= evw), evw, m)

    def mean3(a, b, c):
        m = _tdiv(a + b + c, 3)
        return jnp.where((a >= evw) | (b >= evw) | (c >= evw), jnp.maximum(m, evw), m)

    vert2 = mean2(e_up2, e_dn2)
    green3 = mean3(e_s_xp, e_s_xm, e_m2s)

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    is_green = (xs % 2) != (ys % 2)
    interp_ev = jnp.where(is_green, green3, vert2)
    interp_main = ev2raw_at(interp_ev)

    # main region: y in [2, h-3], x in [2, w-3] (hdr.c:1254,1261)
    region = (ys >= 2) & (ys <= h - 3) & (xs >= 2) & (xs <= w - 3)

    interp = jnp.where(region, interp_main, 0)
    native = jnp.where(region, p, 0)

    # border interpolation (hdr.c:1306-1353), applied in the same order
    top = ys < 3
    interp = jnp.where(top, _shift(p, 2, 0), interp)
    native = jnp.where(top, p, native)
    bot = ys >= h - 4
    interp = jnp.where(bot, _shift(p, -2, 0), interp)
    native = jnp.where(bot, p, native)
    left = (ys >= 2) & (xs < 2)
    interp = jnp.where(left, _shift(p, -2, 0), interp)
    native = jnp.where(left, p, native)
    right = (ys >= 2) & (xs >= w - 3)
    interp = jnp.where(right, _shift(p, -2, -2), interp)
    native = jnp.where(right, _shift(p, 0, -2), native)

    rb = row_bright[:, None]
    dark = jnp.where(rb, interp, native)
    bright = jnp.where(rb, native, interp)
    return dark, bright


_ALIAS_FILTER_OFFS = [
    (-2, -6), (0, -6), (2, -6),
    (-4, -4), (-2, -4), (0, -4), (2, -4), (4, -4),
    (-6, -2), (-4, -2), (-2, -2), (0, -2), (2, -2), (4, -2), (6, -2),
    (-6, 0), (-4, 0), (-2, 0), (0, 0), (2, 0), (4, 0), (6, 0),
    (-6, 2), (-4, 2), (-2, 2), (0, 2), (2, 2), (4, 2), (6, 2),
    (-4, 4), (-2, 4), (0, 4), (2, 4), (4, 4),
    (-2, 6), (0, 6), (2, 6),
]

# (weight, [(dx, dy), ...]) — transcribed exactly from hdr.c:1451-1460,
# including the duplicated offset groups present in the reference
_ALIAS_BLUR_GROUPS = [
    (820, [(0, -2), (-2, 0), (2, 0), (0, 2)]),
    (657, [(-2, -2), (2, -2), (-2, 2), (2, 2)]),
    (421, [(0, -2), (-2, 0), (2, 0), (0, 2)]),
    (337, [(-2, -2), (2, -2), (-2, -2), (2, -2), (-2, 2), (2, 2), (-2, 2), (2, 2)]),
    (173, [(-2, -2), (2, -2), (-2, 2), (2, 2)]),
    (139, [(0, -6), (-6, 0), (6, 0), (0, 6)]),
    (111, [(-2, -6), (2, -6), (-6, -2), (6, -2), (-6, 2), (6, 2), (-2, 6), (2, 6)]),
    (57, [(-2, -6), (2, -6), (-6, -2), (6, -2), (-6, 2), (6, 2), (-2, 6), (2, 6)]),
]


def _build_alias_map(fullres_smooth, halfres_smooth, bright, frcurve_of, ev_of, h, w):
    """Aliasing-likelihood map (build_alias_map, hdr.c:1382-1486)."""
    skip = frcurve_of(bright) > FULLRES_THR
    f = fullres_smooth
    hm = halfres_smooth
    fe = ev_of(f)
    he = ev_of(hm)
    e_lin = jnp.maximum(jnp.abs(f - hm) - int(DARK_NOISE20) * 3 // 2, 0)
    e_log = jnp.abs(fe - he)
    alias = jnp.minimum(jnp.minimum(e_lin // 2, e_log // 16), 65530)
    alias = jnp.where(skip, 0, alias).astype(jnp.int32)
    return _alias_filter_xla(alias, skip, h, w)


def _alias_filter_xla(alias, skip, h, w):
    """The alias-map filter chain: 6th-largest filter, then blur."""
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inner = (ys >= 6) & (ys < h - 6) & (xs >= 6) & (xs < w - 6)

    # 6th largest of the 37-neighborhood (kth_smallest of negated, k=5):
    # running top-6 insertion over the shifted taps — exact, in ~37x6
    # elementwise max/min pairs instead of a full 37-lane sort
    NEG = jnp.int32(-(1 << 30))
    top = [jnp.full_like(alias, NEG) for _ in range(6)]
    for (dx, dy) in _ALIAS_FILTER_OFFS:
        v = _shift(alias, dy, dx)
        for j in range(6):
            hi = jnp.maximum(top[j], v)
            v = jnp.minimum(top[j], v)
            top[j] = hi
    kth = top[5]
    aux = jnp.where(inner & ~skip, kth, alias)

    # gaussian blur with the reference's exact integer group arithmetic
    acc = aux  # center term, weight 1
    for weight, offs in _ALIAS_BLUR_GROUPS:
        g = jnp.zeros_like(aux)
        for (dx, dy) in offs:
            g = g + _shift(aux, dy, dx)
        acc = acc + g * weight // 1024
    alias = jnp.where(inner & ~skip, acc, alias)

    # grayscale: per 2x2 cell max, capped (hdr.c:1466-1483); the loop runs
    # even y,x in [2, h-2) so cells may extend one past h-2 for odd heights
    ny_c = len(range(2, h - 2, 2))
    nx_c = len(range(2, w - 2, 2))
    sub = alias[2 : 2 + 2 * ny_c, 2 : 2 + 2 * nx_c]
    cells = sub.reshape(ny_c, 2, nx_c, 2).max(axis=(1, 3))
    cells = jnp.minimum(cells, ALIAS_MAP_MAX)
    sub = jnp.repeat(jnp.repeat(cells, 2, axis=0), 2, axis=1)
    alias = alias.at[2 : 2 + 2 * ny_c, 2 : 2 + 2 * nx_c].set(sub)
    return alias


def _blur_overexposed(over, h, w):
    """3x3-ish integer blur of the overexposure map (hdr.c:1639-1655)."""
    n4 = sum(_shift(over, dy, dx) for (dx, dy) in [(0, -1), (-1, 0), (1, 0), (0, 1)])
    nd = sum(_shift(over, dy, dx) for (dx, dy) in [(-1, -1), (1, -1), (-1, 1), (1, 1)])
    blurred = over + n4 * 820 // 1024 + nd * 657 // 1024
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inner = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(inner, blurred, over)


def _reconstruct_one(
    img,
    row_bright,
    s,
    a,
    b20,
    white_darkened,
    corr_ev,
    overlap,
    lut,
    ev2raw0,
    frcurve,
    *,
    black20: int,
    white20: int,
    interp_method: int,
    use_fullres: bool,
    use_alias: bool,
    cs_method: int,
    exact_luts: bool,
    white_ev: int,
    arith: bool = False,
):
    h, w = img.shape

    if exact_luts and arith:
        # gather-free bit-exact transforms (ops/evarith.py, self-check gated)
        def ev_of(x):
            return evarith.raw2ev20(jnp.clip(x, 0, (1 << 20) - 1), black20)

        def ev2raw_at(e):
            return evarith.ev2raw20(
                jnp.clip(e, -10 * EV_RESOLUTION, 14 * EV_RESOLUTION - 1),
                black20, white20, white_ev,
            )

        def frcurve_of(x):
            return frcurve[x & 0xFFFFF]
    elif exact_luts:
        def ev_of(x):
            return lut[jnp.clip(x, 0, lut.shape[0] - 1)]

        def ev2raw_at(e):
            return ev2raw0[jnp.clip(e + 10 * EV_RESOLUTION, 0, 24 * EV_RESOLUTION - 1)]

        def frcurve_of(x):
            return frcurve[x & 0xFFFFF]
    else:
        # computed transforms: log2/exp2 instead of 4MB-table gathers
        def ev_of(x):
            return evmath.raw2ev20(x, black20)

        def ev2raw_at(e):
            return evmath.ev2raw20(e, black20, white20, white_ev)

        def frcurve_of(x):
            return evmath.fullres_weight(x, black20)

    # promote to 20 bits (hdr.c:825-837)
    raw = (img.astype(jnp.int32) << 6) & 0xFFFFF

    # exposure matching apply (hdr.c:783-809)
    pf = raw.astype(jnp.float32)
    rb = row_bright[:, None]
    darkened = (pf - black20) * a + black20 + b20 * a
    lifted = pf - b20 + b20 * a
    adj = jnp.where(rb, darkened, lifted)
    adj = jnp.clip(jnp.trunc(adj), 0, 0xFFFFF).astype(jnp.int32)
    raw = jnp.where(raw == 0, 0, adj)

    ev = ev_of(raw)
    white_row = jnp.where(row_bright, jnp.int32(white20), white_darkened)
    evw_row = ev_of(white_row)

    if interp_method == 0:
        from .amaze import amaze_edge_interpolate

        dark, bright = amaze_edge_interpolate(
            raw, ev, ev2raw_at, row_bright, s, ev_of, frcurve_of,
            white_darkened, black20=black20, white20=white20,
        )
        # border interpolation applies the same way afterwards
        dark, bright = _apply_borders(raw, dark, bright, row_bright, h, w)
    else:
        dark, bright = _mean23_interpolate(raw, ev, ev2raw_at, row_bright, s, evw_row, h, w)

    # full-res reconstruction (hdr.c:1355-1380)
    if use_fullres:
        fullres = jnp.where(
            rb, jnp.where(bright < white_darkened, bright, jnp.maximum(bright, dark)), dark
        )
    else:
        fullres = jnp.zeros_like(raw)

    # half-res blend (mix_images, hdr.c:1560-1611)
    max_ev = jnp.log2(jnp.float32(white20 // 64 - black20 // 64))
    bev = ev_of(bright)
    dev = ev_of(dark)
    i_f = (bright & 0xFFFFF).astype(jnp.float32)
    evb = jnp.log2(jnp.maximum(i_f / 64.0 - black20 / 64.0, 1.0)) + corr_ev
    cmix = -jnp.cos(jnp.clip(evb - (max_ev - overlap), 0, overlap) * np.pi / overlap)
    k = jnp.clip((cmix + 1) / 2, 0, 1)
    mixed = jnp.trunc(bev * (1 - k) + dev * k).astype(jnp.int32)
    halfres = ev2raw_at(mixed)

    if cs_method:
        # the 20-bit chroma smooth (hdr.c:1488-1500) always uses the exact
        # integer transforms; gather-free when the arithmetic forms verified
        if arith:
            def cs_ev_of(x):
                return evarith.raw2ev20(jnp.clip(x, 0, (1 << 20) - 1), black20)

            def cs_inv_of(e):
                return evarith.ev2raw20(e, black20, white20, white_ev)
        else:
            def cs_ev_of(x):
                return lut[jnp.clip(x, 0, lut.shape[0] - 1)]

            def cs_inv_of(e):
                return ev2raw0[10 * EV_RESOLUTION :][e]

        fullres_smooth = chroma_smooth_image(fullres, cs_method, cs_ev_of, cs_inv_of, 0) if use_fullres else fullres
        halfres_smooth = chroma_smooth_image(halfres, cs_method, cs_ev_of, cs_inv_of, 0)
    else:
        fullres_smooth = fullres
        halfres_smooth = halfres

    if use_alias:
        alias = _build_alias_map(fullres_smooth, halfres_smooth, bright, frcurve_of, ev_of, h, w)
    else:
        alias = None

    over = jnp.where((bright >= white_darkened) | (dark >= white20), 100, 0).astype(jnp.int32)
    over = _blur_overexposed(over, h, w)

    # final blend (hdr.c:1663-1758)
    f = frcurve_of(bright)
    hrev = ev_of(halfres_smooth).astype(jnp.float32)
    frev = ev_of(fullres).astype(jnp.float32)
    frsev = ev_of(fullres_smooth).astype(jnp.float32)
    c = jnp.clip(alias.astype(jnp.float32) / ALIAS_MAP_MAX, 0, 1) if use_alias else 0.0
    ovf = jnp.clip(over.astype(jnp.float32) / 200.0, 0, 1)
    c = jnp.maximum(c, ovf)
    noisy = jnp.maximum(ovf, 1 - f)
    f = jnp.maximum(f, c)
    fev = noisy * frsev + (1 - noisy) * frev
    sig = (dark + bright) // 2
    f = jnp.maximum(0.0, jnp.minimum(f, (sig - black20).astype(jnp.float32) / (4 * DARK_NOISE20)))
    output = jnp.trunc(hrev * (1 - f) + fev * f).astype(jnp.int32)
    output = jnp.clip(output, -10 * EV_RESOLUTION, 14 * EV_RESOLUTION - 1)
    final20 = ev2raw_at(output)

    # 20 → 16 bit; the reference's dither source is never seeded so its noise
    # is all-zero: out = trunc(v/16 + 0.5) (hdr.c:242,1760-1772)
    return jnp.clip((final20 + 8) >> 4, 0, 65535).astype(jnp.uint16)


def _apply_borders(p, dark, bright, row_bright, h, w):
    """Re-run border interpolation over existing dark/bright arrays."""
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    rb = row_bright[:, None]

    def put(dark, bright, mask, interp_val, native_val):
        d = jnp.where(mask, jnp.where(rb, interp_val, native_val), dark)
        b = jnp.where(mask, jnp.where(rb, native_val, interp_val), bright)
        return d, b

    dark, bright = put(dark, bright, ys < 3, _shift(p, 2, 0), p)
    dark, bright = put(dark, bright, ys >= h - 4, _shift(p, -2, 0), p)
    dark, bright = put(dark, bright, (ys >= 2) & (xs < 2), _shift(p, -2, 0), p)
    dark, bright = put(
        dark, bright, (ys >= 2) & (xs >= w - 3), _shift(p, -2, -2), _shift(p, 0, -2)
    )
    return dark, bright


@functools.partial(jax.jit, static_argnames=("black20", "white20", "interp_method", "use_fullres", "use_alias", "cs_method", "exact_luts", "white_ev", "arith"))
def reconstruct_batch(
    imgs, row_bright, s, a, b20, white_darkened, corr_ev, overlap,
    lut, ev2raw0, frcurve,
    *, black20, white20, interp_method, use_fullres, use_alias, cs_method,
    exact_luts, white_ev, arith=False,
):
    fn = functools.partial(
        _reconstruct_one,
        black20=black20,
        white20=white20,
        interp_method=interp_method,
        use_fullres=use_fullres,
        use_alias=use_alias,
        cs_method=cs_method,
        exact_luts=exact_luts,
        white_ev=white_ev,
        arith=arith,
    )
    return jax.vmap(lambda im, r, ss, aa, bb, wd, ce, ov: fn(im, r, ss, aa, bb, wd, ce, ov, lut, ev2raw0, frcurve))(
        imgs, row_bright, s, a, b20, white_darkened, corr_ev, overlap
    )


# ------------------------------------------------------------ orchestrator


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _analyze_batch(imgs, is_hdr, y_off: int, hh: int, black: int):
    """Field/white/exposure analysis + conversion decisions as one program
    (each stage is itself jitted; nesting inlines them into one dispatch)."""
    from . import dualiso_analysis_dev as dev

    b, _, w = imgs.shape
    ay1 = y_off  # GBRG shifts one row: active_y1 == y_off by construction
    sub_view = imgs[:, y_off : y_off + hh, :]
    okf, ibf = dev.fields_stat_batch(sub_view, black, ay1)
    max_pix = w * hh // 2 // 9
    wd_w, wb_w = dev.white_detect_batch(sub_view, ibf, (ay1, 0, hh, w), max_pix)
    black20s = jnp.full(b, black * 64, jnp.int32)
    min20s = (jnp.minimum(wd_w, wb_w) * 64).astype(jnp.int32)
    mok, a_dev, b_dev, wd_dev = dev.match_exposures_batch(
        sub_view, ibf, black20s, min20s, (hh, w), ay1
    )
    return _decide_batch(is_hdr, okf, ibf, wd_w, mok, a_dev, b_dev, wd_dev, hh, black)


@functools.partial(jax.jit, static_argnums=(8, 9))
def _decide_batch(is_hdr, okf, ibf, wd_w, mok, a_dev, b_dev, wd_dev, hh: int, black: int):
    """Per-frame conversion decision + traced reconstruct scalars, fused into
    one program (the reference's host loop, hdr.c:1853-1886 semantics)."""
    dark_noise_ev = np.log2(8.0) + 6
    ys = np.arange(hh)
    corr_ev_d = jnp.log2(1.0 / a_dev)
    white20s_d = wd_w.astype(jnp.int32) * 64
    lowiso_dr = (
        jnp.log2(jnp.maximum(white20s_d - black * 64, 1).astype(jnp.float32))
        - dark_noise_ev
    )
    ov_d = lowiso_dr - corr_ev_d
    ov_d = ov_d - jnp.minimum(3.0, ov_d - 3.0)
    ok_dev = is_hdr & okf & mok & (ov_d >= 0.5)
    ibb = ibf.astype(bool)
    row_bright = ibb[:, ys % 4] & ok_dev[:, None]
    s_arr = jnp.where(
        (ibb[:, ys % 4] == ibb[:, (ys + 1) % 4]) & ok_dev[:, None], -1, 1
    ).astype(jnp.int32)
    a_arr = jnp.where(ok_dev, a_dev, 1.0).astype(jnp.float32)
    b20_arr = jnp.where(ok_dev, b_dev * 16, 0.0).astype(jnp.float32)
    wd_arr = jnp.where(ok_dev, wd_dev, 1 << 20).astype(jnp.int32)
    ce_arr = jnp.where(ok_dev, corr_ev_d, 0.0).astype(jnp.float32)
    ov_arr = jnp.where(ok_dev, ov_d, 1.0).astype(jnp.float32)
    return ok_dev, row_bright, s_arr, a_arr, b20_arr, wd_arr, ce_arr, ov_arr, white20s_d


@functools.partial(jax.jit, static_argnums=(3,))
def _merge_converted(imgs, out_sub, ok, y_off: int):
    """Write the converted sub-region back and keep failed frames original
    — one program instead of two full-frame dispatches."""
    hh = out_sub.shape[1]
    out = imgs.at[:, y_off : y_off + hh, :].set(out_sub)
    return jnp.where(ok[:, None, None], out, imgs)


def cr2hdr20_batch(imgs, fh, cfg, cal):
    """Full path for a batch. Returns (imgs_u16, ok_mask ndarray)."""
    ri = fh.raw_info
    black, white14 = ri.black_level, ri.white_level
    b, h, w = imgs.shape

    is_hdr_dev = hdr_check_batch(imgs, black, white14)  # pulled later

    # focus + optional bad pixels, horizontal mode — gated PER FRAME on
    # hdr_check like the reference: cr2hdr20_convert_data only reaches the
    # fixes inside `if (hdr_check(...))` (hdr.c:1942-1948), so a frame that
    # fails hdr_check must leave here untouched (it then takes the
    # else-branch normal-mode fixes, main.c:966-973). A frame that passes
    # hdr_check but fails the later analysis KEEPS these dual-mode fixes —
    # the reference mutates image_data in place before returning 0, and the
    # else-branch then stacks normal-mode fixes on top; the per-frame
    # select below reproduces both cases.
    from . import pixels as pixel_ops

    crop_x = (int(fh.vidf["panPosX"]) + 7) & ~7
    crop_y = int(fh.vidf["panPosY"]) & ~1
    fixed = imgs
    if cal is not None and cal.focus_pixel_list is not None and len(cal.focus_pixel_list):
        fixed = pixel_ops.fix_pixel_list_batch(
            fixed, cal.focus_pixel_list, black, crop_x, crop_y, dual_iso=True
        )
    if cfg.fix_bad_pixels:
        # ONE map per clip, like the reference's per-(GUID, aggressive)
        # cache (cs.c:233-312): detected from the first frame that reaches
        # fix_bad_pixels. In full mode that is frame 0 — through this dual
        # path when hdr_check(frame 0) passes, else through the
        # else-branch (run_pipeline detects it there from the normal-mode
        # focus-fixed frame 0). Cached in cal so later batches skip the
        # per-batch host pull AND match the reference's whole-clip map.
        bp = None
        if cal is not None and cal.bad_pixels_done:
            bp = cal.bad_pixel_list
        elif bool(np.asarray(is_hdr_dev[0])):
            bp = pixel_ops.detect_bad_pixels(
                np.asarray(fixed[0]), w, h, black,
                aggressive=(cfg.fix_bad_pixels == 2), crop_x=crop_x, crop_y=crop_y,
            )
            if cal is not None:
                cal.bad_pixel_list = bp
                cal.bad_pixels_done = True
        if bp is not None and len(bp):
            fixed = pixel_ops.fix_pixel_list_batch(fixed, bp, black, crop_x, crop_y, dual_iso=True)
    if fixed is not imgs:
        imgs = jnp.where(is_hdr_dev[:, None, None], fixed, imgs)

    exact = bool(getattr(cfg, "exact_luts", False))

    # per-frame scalars
    ok = np.zeros(b, bool)
    row_bright = np.zeros((b, 1), bool)  # resized below once hh is known
    dark_noise_ev = np.log2(8.0) + 6

    cached_rggb = getattr(cal, "dual_iso_rggb", None) if cal is not None else None

    if exact:
        # reference-exact host analysis (pulls the batch through the host)
        is_hdr = np.asarray(is_hdr_dev)
        host_imgs = np.asarray(imgs)
        rggb = (
            cached_rggb
            if cached_rggb is not None
            else analysis.identify_rggb_or_gbrg(host_imgs[0])
        )
        if cal is not None:
            cal.dual_iso_rggb = rggb
        y_off = 0 if rggb else 1
        hh = h if rggb else h - 1
        ay1 = 0 if rggb else 1
        ys = np.arange(hh)
        row_bright = np.zeros((b, hh), bool)
        s_arr = np.ones((b, hh), np.int32)
        a_arr = np.ones(b, np.float32)
        b20_arr = np.zeros(b, np.float32)
        wd_arr = np.full(b, 1 << 20, np.int32)
        ce_arr = np.zeros(b, np.float32)
        ov_arr = np.ones(b, np.float32)
        whites20 = np.zeros(b, np.int64)
        for i in range(b):
            if not is_hdr[i]:
                continue
            frame = host_imgs[i][y_off : y_off + hh]
            fok, is_bright = analysis.identify_bright_and_dark_fields(frame, black, active_y1=ay1)
            if not fok:
                continue
            wdark, wbright = analysis.white_detect(frame, is_bright, (ay1, 0, hh, w))
            fit = analysis.match_exposures(
                frame, is_bright, black * 64, min(wdark, wbright) * 64, active_y1=ay1
            )
            if not fit.ok:
                continue
            white20_i = wdark * 64
            lowiso_dr = np.log2(white20_i - black * 64) - dark_noise_ev
            overlap = lowiso_dr - fit.corr_ev
            overlap -= min(3.0, overlap - 3.0)
            if overlap < 0.5:
                continue
            ok[i] = True
            ib = np.array(is_bright, bool)
            row_bright[i] = ib[ys % 4]
            s_arr[i] = np.where(ib[ys % 4] == ib[(ys + 1) % 4], -1, 1)
            a_arr[i] = fit.a
            b20_arr[i] = fit.b * 16
            wd_arr[i] = fit.white_darkened
            ce_arr[i] = fit.corr_ev
            ov_arr[i] = overlap
            whites20[i] = white20_i
    else:
        # device analysis: only per-frame scalars leave HBM. The stages chain
        # on-device; everything host-side arrives in ONE device_get (each
        # separate pull is a full host<->device round trip).
        from . import dualiso_analysis_dev as dev

        rggb = (
            cached_rggb
            if cached_rggb is not None
            else bool(np.asarray(dev.rggb_stat(imgs[0])))
        )
        if cal is not None:
            cal.dual_iso_rggb = rggb
        y_off = 0 if rggb else 1
        hh = h if rggb else h - 1
        ay1 = 0 if rggb else 1
        # ONE jitted program for field/white/exposure analysis plus the
        # per-frame conversion decisions (the reference's host loop is pure
        # arithmetic on the analysis scalars): NO mid-path host round trip
        # is needed — except once per clip, to fix the reconstruction's
        # static (black20, white20) compile key (cached in cal like the
        # Bayer order). Failed frames carry neutral scalars; their
        # reconstruction output is discarded by where(ok).
        (
            ok,
            row_bright,
            s_arr,
            a_arr,
            b20_arr,
            wd_arr,
            ce_arr,
            ov_arr,
            white20s_d,
        ) = _analyze_batch(imgs, is_hdr_dev, y_off, hh, black)

        cached_w20 = getattr(cal, "dual_iso_white20", None) if cal is not None else None
        if cached_w20 is None:
            # one host pull per clip: the first batch fixes white20
            ok_np, w20_np = jax.device_get((ok, white20s_d))
            if not ok_np.any():
                return imgs, ok_np
            cached_w20 = int(w20_np[ok_np][0])
            if cal is not None:
                cal.dual_iso_white20 = cached_w20
        whites20 = np.array([cached_w20], np.int64)

    if isinstance(ok, np.ndarray):
        if not ok.any():
            return imgs, ok
        whites20 = np.asarray(whites20)
        whites20 = np.array([int(whites20[ok][0])], np.int64)

    # the reconstruction is compiled per (black20, white20): white_detect can
    # vary per frame; use the first converted frame's white for the LUTs and
    # pass per-frame white via white_darkened/rows (the LUT white clamp only
    # affects values at/above white — PSNR-immaterial for mixed batches)
    black20 = black * 64
    white20 = int(whites20[0])
    exact = bool(getattr(cfg, "exact_luts", False))
    import math as _math

    white_ev = int(round(_math.log2(1 + max(white20 / 64.0 - black20 / 64.0, 0)) * EV_RESOLUTION))
    arith = evarith.self_check()
    if (exact or cfg.chroma_smooth) and not arith:
        lut = jnp.asarray(np.asarray(raw2ev_lut20(black20, white20)))
        ev2raw0 = jnp.asarray(np.asarray(ev2raw_lut20(black20, white20)))
    else:
        lut = jnp.zeros(1, jnp.int32)
        ev2raw0 = jnp.zeros(10 * EV_RESOLUTION + 1, jnp.int32)
    if exact:
        frcurve = jnp.asarray(np.asarray(fullres_curve(black20), np.float32))
    else:
        frcurve = jnp.zeros(1, jnp.float32)

    sub_imgs = imgs[:, y_off : y_off + hh, :]
    out_sub = reconstruct_batch(
        sub_imgs,
        jnp.asarray(row_bright),
        jnp.asarray(s_arr),
        jnp.asarray(a_arr),
        jnp.asarray(b20_arr),
        jnp.asarray(wd_arr),
        jnp.asarray(ce_arr),
        jnp.asarray(ov_arr),
        lut,
        ev2raw0,
        frcurve,
        black20=black20,
        white20=white20,
        interp_method=cfg.hdr_interpolation_method,
        use_fullres=not cfg.hdr_no_fullres,
        use_alias=not cfg.hdr_no_alias_map,
        cs_method=cfg.chroma_smooth,
        exact_luts=exact,
        white_ev=white_ev,
        arith=arith,
    )
    return _merge_converted(imgs, out_sub, jnp.asarray(ok), y_off), ok
