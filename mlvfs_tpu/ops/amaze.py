"""Dual-ISO amaze-edge interpolation (--amaze-edge, the default).

The reference's highest-quality path (amaze_interpolate, hdr.c:954-1229):

  1. squeeze each exposure to half height by deleting the other exposure's
     rows (phase-preserving row permutation);
  2. AMaZE-demosaic the squeezed double-image (greens pre-scaled x0.5 to
     approximate final white balance);
  3. grayscale projection g/2 + r/4 + b/4, de-squeezed;
  4. per-pixel best of 12 edge directions, scored in EV space over an
     11-offset search window (skipped where full-res data will win anyway);
  5. edge-directed 2-tap interpolation of the missing exposure from the
     demosaiced planes, averaged over dir-1/dir/dir+1.

Device mapping: the squeeze is a row permutation (gather); the 12x11x4-tap
scorer unrolls into static shifted adds over the EV-mapped grayscale with a
running argmin (no (12,h,w) stack), and the direction-dependent
interpolation accumulates the picked/neighbor candidates through a select
chain. The AMaZE core itself lives in amaze_core.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .luts import EV_RESOLUTION
from .amaze_core import amaze_demosaic
from .dualiso_full import _shift as _sh  # noqa: circular-safe (function-level import in dualiso_full)

FULLRES_THR = 0.8

# edge direction table (hdr.c:916-938): (ack, a, b, bck); y components are
# multiplied by the per-row exposure direction s
# 12 entries; index 5 is "vertical, preferred"
EDGE_DIRECTIONS = (
    ((-4, 2), (-2, 1), (4, -2), (6, -3)),
    ((-3, 2), (-1, 1), (3, -2), (4, -3)),
    ((-2, 2), (-1, 1), (2, -2), (3, -3)),
    ((-1, 2), (-1, 1), (1, -2), (2, -3)),
    ((-1, 2), (0, 1), (1, -2), (1, -3)),
    ((0, 2), (0, 1), (0, -2), (0, -3)),
    ((1, 2), (0, 1), (-1, -2), (-1, -3)),
    ((1, 2), (1, 1), (-1, -2), (-2, -3)),
    ((2, 2), (1, 1), (-2, -2), (-3, -3)),
    ((3, 2), (1, 1), (-3, -2), (-4, -3)),
    ((4, 2), (2, 1), (-4, -2), (-6, -3)),
    ((6, 2), (3, 1), (-6, -2), (-9, -3)),
)
D0 = len(EDGE_DIRECTIONS) // 2
SEARCH_AREA = 5


def _tdiv(a, b):
    q = jnp.abs(a) // b
    return jnp.where(a < 0, -q, q)


def _srow_shift(a, s, dy_mag, dx):
    """a[y + s*dy_mag, x + dx] with per-row sign s."""
    plus = _sh(a, dy_mag, dx)
    minus = _sh(a, -dy_mag, dx)
    return jnp.where((s == 1)[:, None], plus, minus)


def squeeze_rows(row_bright, h):
    """The squeeze permutation (hdr.c:977-1026): squeezed[y] = target row."""
    rb = row_bright
    dark = ~rb
    idx = jnp.arange(h)
    first_dark = jnp.argmax(dark)
    first_bright = jnp.argmax(rb)
    nd_before = jnp.cumsum(dark) - dark
    nb_before = jnp.cumsum(rb) - rb
    sq_dark = first_dark + nd_before
    sq_bright = (h // 4) * 2 + first_bright + nb_before
    # guard: the reference stops when yh >= h (hdr.c:1025)
    return jnp.where(rb, jnp.minimum(sq_bright, h - 1), sq_dark).astype(jnp.int32)


def edge_pick_xla(evgray, EW_a, EW_b, s, restricted, h, w):
    """Edge scoring + direction-averaged pick: per-pixel best of 12
    directions scored over an 11-offset window (hdr.c:1094-1175), then the
    EV mean of the picked direction and its two neighbors
    (hdr.c:1182-1210). Returns the EV-index plane fed to ev2raw."""
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    # the four row classes used by the direction table: y + {2s, s, -2s, -3s}
    T = {
        2: _srow_shift(evgray, s, 2, 0),
        1: _srow_shift(evgray, s, 1, 0),
        -2: _srow_shift(evgray, -s, 2, 0),
        -3: _srow_shift(evgray, -s, 3, 0),
    }

    def box11(d):
        # sum_{j=-5..5} d(x+j) by shift-doubling partial sums: 8 elementwise
        # passes instead of cumsum's ~13 (log-prefix passes + 2 taps); exact
        # integer adds. S_k(x) = sum_{j=0..k-1} d(x+j).
        s2 = d + _sh(d, 0, 1)
        s4 = s2 + _sh(s2, 0, 2)
        s8 = s4 + _sh(s4, 0, 4)
        return _sh(s8, 0, -SEARCH_AREA) + _sh(s2, 0, 3) + _sh(d, 0, SEARCH_AREA)

    # running argmin over directions — never materializes the (12, h, w)
    # score stack, letting XLA fuse each direction's taps into the compare
    best = None
    d_best = None
    for di, (ack, a, b, bck) in enumerate(EDGE_DIRECTIONS):
        p1 = _sh(T[ack[1]], 0, ack[0])
        p2 = _sh(T[a[1]], 0, a[0])
        p3 = _sh(T[b[1]], 0, b[0])
        p4 = _sh(T[bck[1]], 0, bck[0])
        d = jnp.abs(p1 - p2) + jnp.abs(p2 - p3) + jnp.abs(p3 - p4)
        score = box11(d) + abs(di - D0) * EV_RESOLUTION // 8
        if best is None:
            best, d_best = score, jnp.zeros_like(score)
        else:
            take = score < best  # argmin keeps the first minimum
            best = jnp.where(take, score, best)
            d_best = jnp.where(take, di, d_best)
    d_best = d_best.astype(jnp.int32)
    d_best = jnp.where(restricted, D0, d_best)
    # edge_direction defaults to d0 outside the scored window (hdr.c:1065-1069)
    window = (yy >= 5) & (yy < h - 5) & (xx >= 5) & (xx < w - 5)
    d_best = jnp.where(window, d_best, D0)

    nd = len(EDGE_DIRECTIONS)
    idx0 = d_best
    idxp = jnp.minimum(d_best + 1, nd - 1)
    idxm = jnp.maximum(d_best - 1, 0)
    # accumulate the three per-pixel selections in one pass over directions
    # (select chain, not take_along_axis gathers) without
    # materializing the (12, h, w) candidate stack
    pi0 = pip = pim = None
    for di, (ack, a, b, bck) in enumerate(EDGE_DIRECTIONS):
        eva = _sh(EW_a, 0, a[0])
        evb = _sh(EW_b, 0, b[0])
        val = _tdiv(eva * 2 + evb, 3)
        if pi0 is None:
            pi0 = pip = pim = val
        else:
            pi0 = jnp.where(idx0 == di, val, pi0)
            pip = jnp.where(idxp == di, val, pip)
            pim = jnp.where(idxm == di, val, pim)
    return _tdiv(2 * pi0 + pip + pim, 4)


def amaze_edge_interpolate(
    raw,
    ev,
    ev2raw_at,
    row_bright,
    s,
    ev_of,
    frcurve_of,
    white_darkened,
    *,
    black20: int,
    white20: int,
):
    """(dark, bright) interpolated exposures — amaze_interpolate (hdr.c:954)."""
    h, w = raw.shape
    squeezed = squeeze_rows(row_bright, h)

    # squeeze with green pre-scale (hdr.c:987-1019)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    green_site = (xx % 2) != (yy % 2)
    scaled = jnp.where(green_site, _tdiv(raw - black20, 2) + black20, raw)
    # scatter rows via the inverse permutation (a row gather)
    inv = jnp.zeros(h, jnp.int32).at[squeezed].set(jnp.arange(h, dtype=jnp.int32))
    sq_img = scaled.astype(jnp.float32)[inv]

    red, grn, blu = amaze_demosaic(sq_img)

    # undo green scaling, clamp (hdr.c:1045-1053)
    grn = jnp.clip((grn - black20) * 2.0 + black20, 0, 0xFFFFF)
    red = jnp.clip(red, 0, 0xFFFFF)
    blu = jnp.clip(blu, 0, 0xFFFFF)

    # de-squeeze (gather rows) — every read below is plane[squeezed[y']][x']
    U_r = red[squeezed]
    U_g = grn[squeezed]
    U_b = blu[squeezed]

    # grayscale in original coordinates (hdr.c:1059-1062), trunc to int
    gray = (U_g / 2.0 + U_r / 4.0 + U_b / 4.0).astype(jnp.int32)
    evgray = ev_of(gray)

    # ---- edge direction scoring (hdr.c:1094-1175) -------------------------
    # Reformulated as elementwise passes: each direction's 11-offset search
    #   e_d = sum_j |P1(j)-P2(j)| + |P2(j)-P3(j)| + |P3(j)-P4(j)|
    # is three absolute-difference arrays box-filtered over j — computed with
    # one cumulative sum per difference instead of 11x4 taps per direction.
    fc = frcurve_of(raw)
    rb2 = row_bright[:, None]
    # restricted pixels use only the vertical direction d0 (hdr.c:1105-1133)
    restricted = jnp.where(rb2, raw < white_darkened, fc > FULLRES_THR)

    # ---- edge-directed interpolation taps (hdr.c:1182-1210) ---------------
    # plane of each pixel = its Bayer color; the EV transform commutes with
    # column shifts, so select + row-shift + EV once per row class, then each
    # direction is two lane shifts and an integer mean
    red_mask = (yy % 2 == 0) & (xx % 2 == 0)
    blue_mask = (yy % 2 == 1) & (xx % 2 == 1)

    def ev_class(dy_units):
        sel = [
            _srow_shift(U, s * np.sign(dy_units), abs(dy_units), 0)
            for U in (U_r, U_g, U_b)
        ]
        v = jnp.where(red_mask, sel[0], jnp.where(blue_mask, sel[2], sel[1]))
        return ev_of(jnp.clip(jnp.trunc(v), 0, 0xFFFFF).astype(jnp.int32))

    EW_a = ev_class(1)    # 'a' taps are always at y + s
    EW_b = ev_class(-2)   # 'b' taps are always at y - 2s

    interp_ev = edge_pick_xla(evgray, EW_a, EW_b, s, restricted, h, w)
    interp_val = ev2raw_at(interp_ev)

    region = (yy >= 2) & (yy <= h - 3) & (xx >= 2) & (xx <= w - 3)
    interp = jnp.where(region, interp_val, 0)
    native = jnp.where(region, raw, 0)
    dark = jnp.where(rb2, interp, native)
    bright = jnp.where(rb2, native, interp)
    return dark, bright
