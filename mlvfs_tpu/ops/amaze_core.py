"""AMaZE demosaic (Aliasing Minimization and Zipper Elimination) in XLA.

Ground-up JAX reimplementation of the RawTherapee AMaZE port used by the
reference (amaze_demosaic_RT.c, the a1ex/cr2hdr variant). The reference
processes 160x160 tiles with 16-pixel aprons and SSE2 vectors; stencil radii
never exceed the apron, so a frame-wide formulation over a 16-pixel
reflect-padded array computes identical values while mapping naturally onto
fused elementwise kernels (every stage is shifts + elementwise math).

Key structural translations:
  * tile borders → one reflect pad of the whole frame (the reference's
    mirror fill, amaze_demosaic_RT.c:398-548; corners use its off-by-16
    variant — a known small divergence confined to the 16x16 frame corners);
  * the `indx>>1` half arrays → per-2-pixel-cell values replicated across
    the cell, making every half-index read an ordinary pixel shift;
  * the four in-place raster-order passes (nyquist dilation :999, hvwt
    refinement :1058, pmwt refinement :1281, chroma smoothing :1386) →
    lax.scan over rows; the dilation's within-row chain is an associative
    scan over 2-state transfer functions.

Scan caveat: the reference restarts its raster passes at each tile, while
this implementation propagates them frame-wide — a deliberate divergence
bounded by the PSNR parity gate (the passes are weak local filters).

All math is float32, matching the reference's floats.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


EPS = 1e-5
EPSSQ = 1e-10
ARTHRESH = 0.75
NYQTHRESH = 0.5
CLIP_PT = 1.0  # 1/initialGain, initialGain == 1 (amaze_demosaic_RT.c:37,133)
CLIP_PT8 = 0.8

GAUSSODD = (0.14659727707323927, 0.103592713382435, 0.0732036125103057, 0.0365543548389495)
GAUSSGRAD = (
    0.07384411893421103,
    0.06207511968171489,
    0.0521818194747806,
    0.03687419286733595,
    0.03099732204057846,
    0.018413194161458882,
)
GAUSSEVEN = (0.13719494435797422, 0.05640252782101291)
GQUINC = (0.169917, 0.108947, 0.069855, 0.0287182)


def _sh(a, dy, dx):
    """a shifted so out[y, x] = a[y+dy, x+dx]; wraps (safe under the apron)."""
    if dy == 0 and dx == 0:
        return a
    return jnp.roll(a, (-dy, -dx), (0, 1))


def _ulim(a, b, c):
    return jnp.clip(a, jnp.minimum(b, c), jnp.maximum(b, c))


def _cells(vals, site_mask):
    """Collapse per-site values into per-cell values replicated across the
    2-pixel cell (the reference's indx>>1 arrays)."""
    t = jnp.where(site_mask, vals, 0)
    c = t[:, 0::2] + t[:, 1::2]
    return jnp.repeat(c, 2, axis=1)


def _replicate_row(vals, y, wp):
    """Per-row cell replication: keep the R/B-site pixel of each 2-cell
    (x % 2 == y % 2 in RGGB) and copy it to both pixels."""
    site = (jnp.arange(wp) % 2) == (y % 2)
    t = jnp.where(site, vals, 0)
    c = t[0::2] + t[1::2]
    return jnp.repeat(c, 2)


def amaze_demosaic(raw: jnp.ndarray):
    """Demosaic a (H, W) float32 mosaic (0..65535 scale) → (R, G, B) planes.

    Assumes RGGB (red at even/even), like the reference caller (hdr.c:954).
    """
    h, w = raw.shape
    P = 16
    cfa = jnp.pad(raw.astype(jnp.float32) / 65535.0, P, mode="reflect")
    hp, wp = cfa.shape

    yy = jnp.arange(hp)[:, None]
    xx = jnp.arange(wp)[None, :]
    green = ((yy + xx) % 2) == 1
    rbmask = ~green
    sgn = jnp.where(green, -1.0, 1.0).astype(jnp.float32)

    s = _sh

    # ---- stage: gradients (amaze:568-579) --------------------------------
    delh = jnp.abs(s(cfa, 0, 1) - s(cfa, 0, -1))
    delv = jnp.abs(s(cfa, 1, 0) - s(cfa, -1, 0))
    dirwts0 = EPS + jnp.abs(s(cfa, 2, 0) - cfa) + jnp.abs(cfa - s(cfa, -2, 0)) + delv
    dirwts1 = EPS + jnp.abs(s(cfa, 0, 2) - cfa) + jnp.abs(cfa - s(cfa, 0, -2)) + delh
    delhvsqsum = delh * delh + delv * delv

    # ---- stage: diagonal gradients per cell (amaze:607-625) --------------
    # p1 = (-1,+1) "plus/NE-SW", m1 = (+1,+1) "minus/NW-SE"
    delp_site = jnp.abs(s(cfa, -1, 1) - s(cfa, 1, -1))
    delm_site = jnp.abs(s(cfa, 1, 1) - s(cfa, -1, -1))
    dgp_site = (cfa - s(cfa, -1, 1)) ** 2 + (cfa - s(cfa, 1, -1)) ** 2
    dgm_site = (cfa - s(cfa, 1, 1)) ** 2 + (cfa - s(cfa, -1, -1)) ** 2
    delp = _cells(delp_site, rbmask)
    delm = _cells(delm_site, rbmask)
    dgsqp = _cells(dgp_site, green)
    dgsqm = _cells(dgm_site, green)

    # ---- stage: cardinal interpolation (amaze:690-746) -------------------
    def ratio(n, dwfar, dw, far):
        return n * (dwfar + dw) / (dwfar * (EPS + cfa) + dw * (EPS + far))

    cru = ratio(s(cfa, -1, 0), s(dirwts0, -2, 0), dirwts0, s(cfa, -2, 0))
    crd = ratio(s(cfa, 1, 0), s(dirwts0, 2, 0), dirwts0, s(cfa, 2, 0))
    crl = ratio(s(cfa, 0, -1), s(dirwts1, 0, -2), dirwts1, s(cfa, 0, -2))
    crr = ratio(s(cfa, 0, 1), s(dirwts1, 0, 2), dirwts1, s(cfa, 0, 2))

    guha = s(cfa, -1, 0) + 0.5 * (cfa - s(cfa, -2, 0))
    gdha = s(cfa, 1, 0) + 0.5 * (cfa - s(cfa, 2, 0))
    glha = s(cfa, 0, -1) + 0.5 * (cfa - s(cfa, 0, -2))
    grha = s(cfa, 0, 1) + 0.5 * (cfa - s(cfa, 0, 2))

    guar = jnp.where(jnp.abs(1.0 - cru) < ARTHRESH, cfa * cru, guha)
    gdar = jnp.where(jnp.abs(1.0 - crd) < ARTHRESH, cfa * crd, gdha)
    glar = jnp.where(jnp.abs(1.0 - crl) < ARTHRESH, cfa * crl, glha)
    grar = jnp.where(jnp.abs(1.0 - crr) < ARTHRESH, cfa * crr, grha)

    hwt = s(dirwts1, 0, -1) / (s(dirwts1, 0, -1) + s(dirwts1, 0, 1))
    vwt = s(dirwts0, -1, 0) / (s(dirwts0, 1, 0) + s(dirwts0, -1, 0))

    Gintvha = vwt * gdha + (1.0 - vwt) * guha
    Ginthha = hwt * grha + (1.0 - hwt) * glha

    vcdalt = sgn * (Gintvha - cfa)
    hcdalt = sgn * (Ginthha - cfa)

    clipmask = (cfa > CLIP_PT8) | (Gintvha > CLIP_PT8) | (Ginthha > CLIP_PT8)
    guar = jnp.where(clipmask, guha, guar)
    gdar = jnp.where(clipmask, gdha, gdar)
    glar = jnp.where(clipmask, glha, glar)
    grar = jnp.where(clipmask, grha, grar)
    vcd = jnp.where(clipmask, vcdalt, sgn * ((vwt * gdar + (1.0 - vwt) * guar) - cfa))
    hcd = jnp.where(clipmask, hcdalt, sgn * ((hwt * grar + (1.0 - hwt) * glar) - cfa))

    dgintv = jnp.minimum((guha - gdha) ** 2, (guar - gdar) ** 2)
    dginth = jnp.minimum((glha - grha) ** 2, (glar - grar) ** 2)

    # ---- stage: variance-based selection + bounding (amaze:805-874) ------
    def var3(a, d1, d2):
        x0, x1, x2 = s(a, *d1), a, s(a, *d2)
        return 3.0 * (x0 * x0 + x1 * x1 + x2 * x2) - (x0 + x1 + x2) ** 2

    hcdvar = var3(hcd, (0, -2), (0, 2))
    hcdaltvar = var3(hcdalt, (0, -2), (0, 2))
    vcdvar = var3(vcd, (-2, 0), (2, 0))
    vcdaltvar = var3(vcdalt, (-2, 0), (2, 0))
    hcd = jnp.where(hcdaltvar < hcdvar, hcdalt, hcd)
    vcd = jnp.where(vcdaltvar < vcdvar, vcdalt, vcd)

    cl, cr_ = s(cfa, 0, -1), s(cfa, 0, 1)
    cu, cd = s(cfa, -1, 0), s(cfa, 1, 0)

    # green sites (amaze:817-841)
    Ginth_g = -hcd + cfa
    Gintv_g = -vcd + cfa
    hwt_g = 1.0 - 3.0 * hcd / (EPS + Ginth_g + cfa)
    hcd_g_hi = -_ulim(Ginth_g, cl, cr_) + cfa
    hcd_g = jnp.where(
        hcd > 0,
        jnp.where(3.0 * hcd > (Ginth_g + cfa), hcd_g_hi, hwt_g * hcd + (1.0 - hwt_g) * hcd_g_hi),
        hcd,
    )
    hcd_g = jnp.where(Ginth_g > CLIP_PT, hcd_g_hi, hcd_g)
    vwt_g = 1.0 - 3.0 * vcd / (EPS + Gintv_g + cfa)
    vcd_g_hi = -_ulim(Gintv_g, cu, cd) + cfa
    vcd_g = jnp.where(
        vcd > 0,
        jnp.where(3.0 * vcd > (Gintv_g + cfa), vcd_g_hi, vwt_g * vcd + (1.0 - vwt_g) * vcd_g_hi),
        vcd,
    )
    vcd_g = jnp.where(Gintv_g > CLIP_PT, vcd_g_hi, vcd_g)

    # R/B sites (amaze:843-869)
    Ginth_rb = hcd + cfa
    Gintv_rb = vcd + cfa
    hwt_rb = 1.0 + 3.0 * hcd / (EPS + Ginth_rb + cfa)
    hcd_rb_lo = _ulim(Ginth_rb, cl, cr_) - cfa
    hcd_rb = jnp.where(
        hcd < 0,
        jnp.where(3.0 * hcd < -(Ginth_rb + cfa), hcd_rb_lo, hwt_rb * hcd + (1.0 - hwt_rb) * hcd_rb_lo),
        hcd,
    )
    hcd_rb = jnp.where(Ginth_rb > CLIP_PT, hcd_rb_lo, hcd_rb)
    vwt_rb = 1.0 + 3.0 * vcd / (EPS + Gintv_rb + cfa)
    vcd_rb_lo = _ulim(Gintv_rb, cu, cd) - cfa
    vcd_rb = jnp.where(
        vcd < 0,
        jnp.where(3.0 * vcd < -(Gintv_rb + cfa), vcd_rb_lo, vwt_rb * vcd + (1.0 - vwt_rb) * vcd_rb_lo),
        vcd,
    )
    vcd_rb = jnp.where(Gintv_rb > CLIP_PT, vcd_rb_lo, vcd_rb)

    hcd = jnp.where(green, hcd_g, hcd_rb)
    vcd = jnp.where(green, vcd_g, vcd_rb)
    cddiffsq = (vcd - hcd) ** 2  # meaningful at R/B sites

    # ---- stage: directional weights hvwt (amaze:922-962) -----------------
    uave = vcd + s(vcd, -1, 0) + s(vcd, -2, 0) + s(vcd, -3, 0)
    dave = vcd + s(vcd, 1, 0) + s(vcd, 2, 0) + s(vcd, 3, 0)
    lave = hcd + s(hcd, 0, -1) + s(hcd, 0, -2) + s(hcd, 0, -3)
    rave = hcd + s(hcd, 0, 1) + s(hcd, 0, 2) + s(hcd, 0, 3)

    def var4(a, d1, d2, d3, ave):
        return (
            (a - ave) ** 2
            + (s(a, *d1) - ave) ** 2
            + (s(a, *d2) - ave) ** 2
            + (s(a, *d3) - ave) ** 2
        )

    Dgrbvvaru = var4(vcd, (-1, 0), (-2, 0), (-3, 0), uave)
    Dgrbvvard = var4(vcd, (1, 0), (2, 0), (3, 0), dave)
    Dgrbhvarl = var4(hcd, (0, -1), (0, -2), (0, -3), lave)
    Dgrbhvarr = var4(hcd, (0, 1), (0, 2), (0, 3), rave)

    vcdvar_w = EPSSQ + vwt * Dgrbvvard + (1.0 - vwt) * Dgrbvvaru
    hcdvar_w = EPSSQ + hwt * Dgrbhvarr + (1.0 - hwt) * Dgrbhvarl

    fluct_u = dgintv + s(dgintv, -1, 0) + s(dgintv, -2, 0)
    fluct_d = dgintv + s(dgintv, 1, 0) + s(dgintv, 2, 0)
    fluct_l = dginth + s(dginth, 0, -1) + s(dginth, 0, -2)
    fluct_r = dginth + s(dginth, 0, 1) + s(dginth, 0, 2)
    vcdvar1 = EPSSQ + vwt * fluct_d + (1.0 - vwt) * fluct_u
    hcdvar1 = EPSSQ + hwt * fluct_r + (1.0 - hwt) * fluct_l

    varwt = hcdvar_w / (vcdvar_w + hcdvar_w)
    diffwt = hcdvar1 / (vcdvar1 + hcdvar1)
    agree = ((0.5 - varwt) * (0.5 - diffwt) > 0) & (jnp.abs(0.5 - diffwt) < jnp.abs(0.5 - varwt))
    hvwt = _cells(jnp.where(agree, varwt, diffwt), rbmask)

    # ---- stage: Nyquist test (amaze:967-996) ------------------------------
    def ring(a, offs):
        return sum(s(a, dy, dx) for dy, dx in offs)

    nyqtest = (
        GAUSSODD[0] * cddiffsq
        + GAUSSODD[1] * ring(cddiffsq, [(-1, -1), (-1, 1), (1, -1), (1, 1)])
        + GAUSSODD[2] * ring(cddiffsq, [(-2, 0), (0, -2), (0, 2), (2, 0)])
        + GAUSSODD[3] * ring(cddiffsq, [(-2, -2), (-2, 2), (2, -2), (2, 2)])
    )
    nyqtest -= NYQTHRESH * (
        GAUSSGRAD[0] * delhvsqsum
        + GAUSSGRAD[1] * ring(delhvsqsum, [(-1, 0), (0, 1), (0, -1), (1, 0)])
        + GAUSSGRAD[2] * ring(delhvsqsum, [(-1, -1), (-1, 1), (1, -1), (1, 1)])
        + GAUSSGRAD[3] * ring(delhvsqsum, [(-2, 0), (0, -2), (0, 2), (2, 0)])
        + GAUSSGRAD[4]
        * ring(delhvsqsum, [(-2, -1), (-2, 1), (-1, -2), (-1, 2), (1, -2), (1, 2), (2, -1), (2, 1)])
        + GAUSSGRAD[5] * ring(delhvsqsum, [(-2, -2), (-2, 2), (2, -2), (2, 2)])
    )
    nyq0 = _cells(jnp.where(rbmask & (nyqtest > 0), 1, 0), rbmask).astype(jnp.int32)

    nyq = _nyquist_dilate(nyq0, hp, wp)

    # ---- stage: area interpolation in Nyquist regions (amaze:1016-1045) ---
    qh = cfa - 0.5 * (cl + cr_)
    qv = cfa - 0.5 * (cu + cd)
    qsh = 0.5 * ((cfa - cl) ** 2 + (cfa - cr_) ** 2)
    qsv = 0.5 * ((cfa - cu) ** 2 + (cfa - cd) ** 2)
    nm = (nyq > 0) & rbmask
    nmf = nm.astype(jnp.float32)

    def ring77(a):
        # the 7x7 stride-2 box is separable: 49 taps -> 7 + 7 (the float
        # summation order differs from the flat sum; PSNR-immaterial)
        r = sum(s(a, 0, j) for j in range(-6, 7, 2))
        return sum(s(r, i, 0) for i in range(-6, 7, 2))

    sumh = ring77(qh * nmf)
    sumv = ring77(qv * nmf)
    sumsqh = ring77(qsh * nmf)
    sumsqv = ring77(qsv * nmf)
    areawt = ring77(nmf)
    hcdvar_a = EPSSQ + jnp.abs(areawt * sumsqh - sumh * sumh)
    vcdvar_a = EPSSQ + jnp.abs(areawt * sumsqv - sumv * sumv)
    hvwt_area = hcdvar_a / (vcdvar_a + hcdvar_a)
    hvwt = jnp.where(_cells(nmf, rbmask) > 0, _cells(jnp.where(nm, hvwt_area, 0.0), rbmask), hvwt)

    # ---- stage: hvwt refinement scan + populate G (amaze:1050-1075) -------
    hvwt = _neighbor_refine_scan(hvwt, hp, wp)

    Dgrb0 = _cells(jnp.where(rbmask, hcd * (1.0 - hvwt) + vcd * hvwt, 0.0), rbmask)
    rgbgreen = jnp.where(rbmask, cfa + Dgrb0, cfa)
    curv_h = (rgbgreen - 0.5 * (s(rgbgreen, 0, -1) + s(rgbgreen, 0, 1))) ** 2
    curv_v = (rgbgreen - 0.5 * (s(rgbgreen, -1, 0) + s(rgbgreen, 1, 0))) ** 2
    nyqc = _cells(nmf, rbmask) > 0
    Dgrb2h = jnp.where(nyqc, _cells(jnp.where(nm, curv_h, 0.0), rbmask), 0.0)
    Dgrb2v = jnp.where(nyqc, _cells(jnp.where(nm, curv_v, 0.0), rbmask), 0.0)

    # ---- stage: Nyquist refinement via G curvature (amaze:1085-1102) ------
    gvarh = EPSSQ + (
        GQUINC[0] * Dgrb2h
        + GQUINC[1] * ring(Dgrb2h, [(-1, -1), (-1, 1), (1, -1), (1, 1)])
        + GQUINC[2] * ring(Dgrb2h, [(-2, 0), (0, -2), (0, 2), (2, 0)])
        + GQUINC[3] * ring(Dgrb2h, [(-2, -2), (-2, 2), (2, -2), (2, 2)])
    )
    gvarv = EPSSQ + (
        GQUINC[0] * Dgrb2v
        + GQUINC[1] * ring(Dgrb2v, [(-1, -1), (-1, 1), (1, -1), (1, 1)])
        + GQUINC[2] * ring(Dgrb2v, [(-2, 0), (0, -2), (0, 2), (2, 0)])
        + GQUINC[3] * ring(Dgrb2v, [(-2, -2), (-2, 2), (2, -2), (2, 2)])
    )
    refined = (hcd * gvarv + vcd * gvarh) / (gvarv + gvarh)
    Dgrb0 = jnp.where(nyqc & rbmask, _cells(jnp.where(nm, refined, 0.0), rbmask), Dgrb0)
    rgbgreen = jnp.where(rbmask, cfa + Dgrb0, rgbgreen)

    # ---- stage: diagonal interpolation (amaze:1183-1256) ------------------
    cm1, cm2 = s(cfa, 1, 1), s(cfa, 2, 2)
    cm1n, cm2n = s(cfa, -1, -1), s(cfa, -2, -2)
    cp1, cp2 = s(cfa, -1, 1), s(cfa, -2, 2)
    cp1n, cp2n = s(cfa, 1, -1), s(cfa, 2, -2)

    crse = 2.0 * cm1 / (EPS + cfa + cm2)
    crnw = 2.0 * cm1n / (EPS + cfa + cm2n)
    crne = 2.0 * cp1 / (EPS + cfa + cp2)
    crsw = 2.0 * cp1n / (EPS + cfa + cp2n)

    rbse = jnp.where(jnp.abs(1.0 - crse) < ARTHRESH, cfa * crse, cm1 + 0.5 * (cfa - cm2))
    rbnw = jnp.where(jnp.abs(1.0 - crnw) < ARTHRESH, cfa * crnw, cm1n + 0.5 * (cfa - cm2n))
    rbne = jnp.where(jnp.abs(1.0 - crne) < ARTHRESH, cfa * crne, cp1 + 0.5 * (cfa - cp2))
    rbsw = jnp.where(jnp.abs(1.0 - crsw) < ARTHRESH, cfa * crsw, cp1n + 0.5 * (cfa - cp2n))

    wtse = EPS + delm + s(delm, 1, 1) + s(delm, 2, 2)
    wtnw = EPS + delm + s(delm, -1, -1) + s(delm, -2, -2)
    wtne = EPS + delp + s(delp, -1, 1) + s(delp, -2, 2)
    wtsw = EPS + delp + s(delp, 1, -1) + s(delp, 2, -2)

    rbm_ = (wtse * rbnw + wtnw * rbse) / (wtse + wtnw)
    rbp_ = (wtne * rbsw + wtsw * rbne) / (wtne + wtsw)

    rbvarm = EPSSQ + (
        GAUSSEVEN[0] * ring(dgsqm, [(-1, 0), (0, -1), (0, 1), (1, 0)])
        + GAUSSEVEN[1]
        * ring(dgsqm, [(-2, -2), (-2, 0), (-1, -1), (-1, 1), (1, -1), (1, 1), (2, -2), (2, 0)])
    )
    rbvarp = EPSSQ + (
        GAUSSEVEN[0] * ring(dgsqp, [(-1, 0), (0, -1), (0, 1), (1, 0)])
        + GAUSSEVEN[1]
        * ring(dgsqp, [(-2, -2), (-2, 0), (-1, -1), (-1, 1), (1, -1), (1, 1), (2, -2), (2, 0)])
    )
    pmwt_site = rbvarm / (rbvarp + rbvarm)

    # bound rbp/rbm (amaze:1231-1249)
    pwt = 2.0 * (cfa - rbp_) / (EPS + rbp_ + cfa)
    rbp_b = _ulim(rbp_, cp1n, cp1)
    rbp_ = jnp.where(
        rbp_ < cfa,
        jnp.where(2.0 * rbp_ < cfa, rbp_b, pwt * rbp_ + (1.0 - pwt) * rbp_b),
        rbp_,
    )
    mwt = 2.0 * (cfa - rbm_) / (EPS + rbm_ + cfa)
    rbm_b = _ulim(rbm_, cm1n, cm1)
    rbm_ = jnp.where(
        rbm_ < cfa,
        jnp.where(2.0 * rbm_ < cfa, rbm_b, mwt * rbm_ + (1.0 - mwt) * rbm_b),
        rbm_,
    )
    rbp_ = jnp.where(rbp_ > CLIP_PT, _ulim(rbp_, cp1n, cp1), rbp_)
    rbm_ = jnp.where(rbm_ > CLIP_PT, _ulim(rbm_, cm1n, cm1), rbm_)

    rbp = _cells(jnp.where(rbmask, rbp_, 0.0), rbmask)
    rbm = _cells(jnp.where(rbmask, rbm_, 0.0), rbmask)
    pmwt = _cells(jnp.where(rbmask, pmwt_site, 0.0), rbmask)

    # pmwt refinement scan + rbint (amaze:1277-1284)
    pmwt = _neighbor_refine_scan(pmwt, hp, wp)
    rbint = jnp.where(rbmask, 0.5 * (cfa + rbm * (1.0 - pmwt) + rbp * pmwt), 0.0)
    rbint = _cells(rbint, rbmask)

    # ---- stage: G correction via R+B (amaze:1287-1352) --------------------
    cru2 = cu * 2.0 / (EPS + rbint + s(rbint, -2, 0))
    crd2 = cd * 2.0 / (EPS + rbint + s(rbint, 2, 0))
    crl2 = cl * 2.0 / (EPS + rbint + s(rbint, 0, -2))
    crr2 = cr_ * 2.0 / (EPS + rbint + s(rbint, 0, 2))
    gu = jnp.where(jnp.abs(1.0 - cru2) < ARTHRESH, rbint * cru2, cu + 0.5 * (rbint - s(rbint, -2, 0)))
    gd = jnp.where(jnp.abs(1.0 - crd2) < ARTHRESH, rbint * crd2, cd + 0.5 * (rbint - s(rbint, 2, 0)))
    gl = jnp.where(jnp.abs(1.0 - crl2) < ARTHRESH, rbint * crl2, cl + 0.5 * (rbint - s(rbint, 0, -2)))
    gr = jnp.where(jnp.abs(1.0 - crr2) < ARTHRESH, rbint * crr2, cr_ + 0.5 * (rbint - s(rbint, 0, 2)))

    Gintv2 = (s(dirwts0, -1, 0) * gd + s(dirwts0, 1, 0) * gu) / (s(dirwts0, 1, 0) + s(dirwts0, -1, 0))
    Ginth2 = (s(dirwts1, 0, -1) * gr + s(dirwts1, 0, 1) * gl) / (s(dirwts1, 0, -1) + s(dirwts1, 0, 1))

    vwt2 = 2.0 * (rbint - Gintv2) / (EPS + Gintv2 + rbint)
    Gv_b = _ulim(Gintv2, cu, cd)
    Gintv2 = jnp.where(
        Gintv2 < rbint,
        jnp.where(2.0 * Gintv2 < rbint, Gv_b, vwt2 * Gintv2 + (1.0 - vwt2) * Gv_b),
        Gintv2,
    )
    hwt2 = 2.0 * (rbint - Ginth2) / (EPS + Ginth2 + rbint)
    Gh_b = _ulim(Ginth2, cl, cr_)
    Ginth2 = jnp.where(
        Ginth2 < rbint,
        jnp.where(2.0 * Ginth2 < rbint, Gh_b, hwt2 * Ginth2 + (1.0 - hwt2) * Gh_b),
        Ginth2,
    )
    Ginth2 = jnp.where(Ginth2 > CLIP_PT, _ulim(Ginth2, cl, cr_), Ginth2)
    Gintv2 = jnp.where(Gintv2 > CLIP_PT, _ulim(Gintv2, cu, cd), Gintv2)

    use_diag = jnp.abs(0.5 - pmwt) >= jnp.abs(0.5 - hvwt)
    g_diag = Ginth2 * (1.0 - hvwt) + Gintv2 * hvwt
    upd = rbmask & use_diag
    rgbgreen = jnp.where(upd, g_diag, rgbgreen)
    Dgrb0_site = jnp.where(use_diag, g_diag - cfa, Dgrb0)
    Dgrb0 = _cells(jnp.where(rbmask, Dgrb0_site, 0.0), rbmask)

    # ---- stage: chrominance smoothing (amaze:1358-1398) -------------------
    bsite = ((yy % 2) == 1) & ((xx % 2) == 1)  # blue sites (RGGB)
    bcell = _cells(bsite.astype(jnp.float32), rbmask) > 0
    Dgrb1 = jnp.where(bcell, Dgrb0, 0.0)
    Dgrb0 = jnp.where(bcell, 0.0, Dgrb0)

    Dgrb0, Dgrb1 = _chroma_smooth_scan(Dgrb0, Dgrb1, hp, wp)

    # ---- stage: output (amaze:1401-1468) ----------------------------------
    hv_u, hv_d = s(hvwt, -1, 0), s(hvwt, 1, 0)
    hv_l, hv_r = s(hvwt, 0, -1), s(hvwt, 0, 1)
    wsum = hv_u + (1.0 - hv_r) + (1.0 - hv_l) + hv_d

    def chroma_at_green(D):
        acc = hv_u * s(D, -1, 0) + (1.0 - hv_r) * s(D, 0, 1) + (1.0 - hv_l) * s(D, 0, -1) + hv_d * s(D, 1, 0)
        return acc / wsum

    red_g = rgbgreen - chroma_at_green(Dgrb0)
    blue_g = rgbgreen - chroma_at_green(Dgrb1)
    red_rb = rgbgreen - Dgrb0
    blue_rb = rgbgreen - Dgrb1

    red = jnp.where(green, red_g, red_rb) * 65535.0
    blue = jnp.where(green, blue_g, blue_rb) * 65535.0
    gout = rgbgreen * 65535.0

    sl = (slice(P, P + h), slice(P, P + w))
    return red[sl], gout[sl], blue[sl]


# Raster-pass scan grid: the reference's 160-row tiles (128-row step +
# 16-row aprons, amaze_demosaic_RT.c:135), where it restarts each in-place
# raster pass. The grid stays reference-exact: the tile count is the scans'
# parallel width, the 160-row tile their sequential length.
SCAN_TILE = 160
SCAN_STEP = 128
_APRON = 16


def _chunk_rows(arr, T, tile=SCAN_TILE, step=SCAN_STEP):
    """(hp, wp) → (T, tile, wp): overlapping row chunks on the scan grid
    (tile t covers padded rows [step*t, step*t + tile))."""
    hp = arr.shape[0]
    need = step * T + (tile - step)
    if need > hp:
        arr = jnp.pad(arr, ((0, need - hp), (0, 0)), mode="edge")
    idx = (jnp.arange(T) * step)[:, None] + jnp.arange(tile)[None, :]
    return arr[idx]


def _unchunk_rows(out, hp, tile=SCAN_TILE, step=SCAN_STEP):
    """Inverse of _chunk_rows keeping each tile's centre rows [APRON, APRON+step)."""
    first = out[0, :_APRON]
    mid = out[:, _APRON : _APRON + step].reshape(-1, out.shape[-1])
    last = out[-1, _APRON + step :]
    return jnp.concatenate([first, mid, last], axis=0)[:hp]


def _n_tiles(hp):
    return max(1, -(-(hp - (SCAN_TILE - SCAN_STEP)) // SCAN_STEP))


def _replicate_rows_t(vals, r, wp):
    """Cell replication for (T, wp) rows at padded row parity r % 2."""
    site = (jnp.arange(wp) % 2) == (r % 2)
    t = jnp.where(site[None, :], vals, 0)
    c = t[:, 0::2] + t[:, 1::2]
    return jnp.repeat(c, 2, axis=1)


def _neighbor_refine_scan(wt, hp, wp):
    """In-place raster refinement: replace wt with the diagonal-neighbor mean
    when the neighbors are more decisive (amaze:1054-1058, :1280-1281).

    Row y reads the updated row y-1 and the original row y+1. Chunked on the
    reference's 160-row tile grid: the reference restarts this pass at every
    tile, so chunks both match its semantics and run in parallel.
    """
    T = _n_tiles(hp)
    tiles = _chunk_rows(wt, T)               # (T, 160, wp)
    tiles_next = _chunk_rows(jnp.roll(wt, -1, 0), T)

    def step(prev_rows, xs):
        old, nxt, r = xs                      # (T, wp), (T, wp), row index
        alt = 0.25 * (
            jnp.roll(prev_rows, 1, -1)
            + jnp.roll(prev_rows, -1, -1)
            + jnp.roll(nxt, 1, -1)
            + jnp.roll(nxt, -1, -1)
        )
        new = jnp.where(jnp.abs(0.5 - old) < jnp.abs(0.5 - alt), alt, old)
        new = _replicate_rows_t(new, r, wp)
        return new, new

    xs = (tiles.transpose(1, 0, 2), tiles_next.transpose(1, 0, 2), jnp.arange(SCAN_TILE))
    # per-step work is tiny (T, wp); unrolling amortizes the per-iteration
    # loop overhead of these row chains
    _, rows = jax.lax.scan(step, tiles[:, 0], xs, unroll=16)
    return _unchunk_rows(rows.transpose(1, 0, 2), hp)


def _nyquist_dilate(nyq, hp, wp):
    """Sequential majority-vote dilation (amaze:998-1010): rows via lax.scan
    over the 160-row tile chunks, the within-row chain on new[x-2] via an
    associative scan over 2-state transfer functions."""
    T = _n_tiles(hp)
    t_o = _chunk_rows(nyq, T).transpose(1, 0, 2)           # (160, T, wp)
    t_d1 = _chunk_rows(jnp.roll(nyq, -1, 0), T).transpose(1, 0, 2)
    t_d2 = _chunk_rows(jnp.roll(nyq, -2, 0), T).transpose(1, 0, 2)

    def step(carry, xs):
        r2new, r1new = carry                   # (T, wp) updated rows y-2, y-1
        o, d1, d2, r = xs
        K = (
            r2new
            + jnp.roll(r1new, 1, -1)
            + jnp.roll(r1new, -1, -1)
            + o
            + jnp.roll(o, -2, -1)
            + jnp.roll(d1, 1, -1)
            + jnp.roll(d1, -1, -1)
            + d2
        )
        # transfer function per cell: new = f(a), a = new[x-2];
        # temp = a + K: >4 → 1, <4 → 0, ==4 → old
        f0 = jnp.where(K > 4, 1, jnp.where(K < 4, 0, o))
        f1 = jnp.where(K + 1 > 4, 1, jnp.where(K + 1 < 4, 0, o))
        site = (jnp.arange(wp) % 2) == (r % 2)
        f0c = jnp.where(site[None], f0, 0)[:, 0::2] + jnp.where(site[None], f0, 0)[:, 1::2]
        f1c = jnp.where(site[None], f1, 0)[:, 0::2] + jnp.where(site[None], f1, 0)[:, 1::2]

        def compose(a, b):
            a0, a1 = a
            b0, b1 = b
            return (jnp.where(a0 == 0, b0, b1), jnp.where(a1 == 0, b0, b1))

        p0, _ = jax.lax.associative_scan(compose, (f0c, f1c), axis=1)
        new = jnp.repeat(p0, 2, axis=1)  # chain seeded with a = 0 at tile left
        return (r1new, new), new

    zero = jnp.zeros((T, wp), nyq.dtype)
    xs = (t_o, t_d1, t_d2, jnp.arange(SCAN_TILE))
    _, rows = jax.lax.scan(step, (zero, zero), xs, unroll=16)
    return _unchunk_rows(rows.transpose(1, 0, 2), hp)


def _chroma_smooth_scan(D0, D1, hp, wp):
    """Directional chrominance interpolation, in-place raster semantics
    (amaze:1386-1398). At R sites updates plane 1 (G-B), at B sites plane 0.
    Row y reads rows y-3, y-1 (updated) and y+1, y+3 (original). Chunked on
    the reference's tile grid like the other raster passes."""
    T = _n_tiles(hp)
    chunks = {}
    for name, dy in (("o", 0), ("d1", 1), ("d3", 3)):
        chunks[name] = jnp.stack(
            [
                _chunk_rows(jnp.roll(D0, -dy, 0), T).transpose(1, 0, 2),
                _chunk_rows(jnp.roll(D1, -dy, 0), T).transpose(1, 0, 2),
            ],
            axis=1,
        )  # (160, 2, T, wp)

    def step(carry, xs):
        newrows = carry                        # (2, 3, T, wp): rows y-3..y-1
        o, d1, d3, r = xs                      # o/d1/d3: (2, T, wp)

        def rd_new(p, dy, dx):
            return jnp.roll(newrows[p, 3 + dy], -dx, -1)

        def rd_old_row(row, p, dx):
            return jnp.roll(row[p], -dx, -1)

        outs = []
        for p in range(2):
            nm1 = rd_new(p, -1, -1)
            pp1 = rd_new(p, -1, 1)
            nm3 = rd_new(p, -3, -3)
            pp3 = rd_new(p, -3, 3)
            om1 = rd_old_row(d1, p, 1)
            op1 = rd_old_row(d1, p, -1)
            om3 = rd_old_row(d3, p, 3)
            op3 = rd_old_row(d3, p, -3)
            wtnw = 1.0 / (EPS + jnp.abs(nm1 - om1) + jnp.abs(nm1 - nm3) + jnp.abs(om1 - nm3))
            wtne = 1.0 / (EPS + jnp.abs(pp1 - op1) + jnp.abs(pp1 - pp3) + jnp.abs(op1 - pp3))
            wtsw = 1.0 / (EPS + jnp.abs(op1 - pp1) + jnp.abs(op1 - om3) + jnp.abs(pp1 - op3))
            wtse = 1.0 / (EPS + jnp.abs(om1 - nm1) + jnp.abs(om1 - op3) + jnp.abs(nm1 - om3))
            val = (
                wtnw * (1.325 * nm1 - 0.175 * nm3 - 0.075 * rd_new(p, -1, -3) - 0.075 * rd_new(p, -3, -1))
                + wtne * (1.325 * pp1 - 0.175 * pp3 - 0.075 * rd_new(p, -1, 3) - 0.075 * rd_new(p, -3, 1))
                + wtsw * (1.325 * op1 - 0.175 * op3 - 0.075 * rd_old_row(d1, p, -3) - 0.075 * rd_old_row(d3, p, -1))
                + wtse * (1.325 * om1 - 0.175 * om3 - 0.075 * rd_old_row(d1, p, 3) - 0.075 * rd_old_row(d3, p, 1))
            ) / (wtnw + wtne + wtsw + wtse)
            outs.append(val)

        c_is_one = (r % 2) == 0  # R rows (even padded parity) update plane 1
        new0 = jnp.where(c_is_one, o[0], _replicate_rows_t(outs[0], r, wp))
        new1 = jnp.where(c_is_one, _replicate_rows_t(outs[1], r, wp), o[1])
        newstack = jnp.stack([new0, new1])     # (2, T, wp)
        carry_out = jnp.concatenate([newrows[:, 1:], newstack[:, None]], axis=1)
        return carry_out, newstack

    init = jnp.zeros((2, 3, T, wp), D0.dtype)
    xs = (chunks["o"], chunks["d1"], chunks["d3"], jnp.arange(SCAN_TILE))
    # a smaller unroll than the other two scans: this one carries six rows
    _, rows = jax.lax.scan(step, init, xs, unroll=4)  # rows: (160, 2, T, wp)
    out0 = _unchunk_rows(rows[:, 0].transpose(1, 0, 2), hp)
    out1 = _unchunk_rows(rows[:, 1].transpose(1, 0, 2), hp)
    return out0, out1

