"""Gather-free, *bit-exact* raw<->EV transforms in double-single f32 arithmetic.

The reference's EV tables (get_raw2ev main.c:154-179, get_ev2raw
main.c:181-196) are pure log2/exp2 curves truncated to int. These
routines compute the same integers arithmetically, with no table gather,
provably matching the f64-built tables bit for bit:

  * The tables are black-independent once shifted: raw2ev(p; black) depends
    only on s = p - black, and ev2raw only on the EV index. Both domains are
    finite (s in [1, 65535]; ev in [0, 14*EV_RESOLUTION)), so exactness is
    established by EXHAUSTIVE comparison, not sampling (tests/test_evarith.py
    runs every value; self_check() repeats it at runtime on the live backend
    and the callers fall back to the LUT gather if it ever fails).
  * The margin is analytic, not luck: the closest any exact value sits to a
    truncation boundary is 2.5e-6 EV steps (raw2ev, s=38893) and 1.15e-6
    raw units (ev2raw, ev=249277), measured exhaustively in f64. The
    double-single evaluation below carries ~2^-45 relative error — five
    orders of magnitude inside the gap — so floor() can never land on the
    wrong side on any IEEE-f32 backend.

Only IEEE add/sub/mul/div/floor and integer bit ops are used (no backend
log2/exp2, whose rounding differs between backends). Division need
not be correctly rounded: the double-single quotient is residual-corrected.

Double-single primitives follow Dekker (1971) / the QD library's df64
algorithms; the log2 core uses the atanh series on t=(m-1)/(m+1) after
normalizing the mantissa to [sqrt(1/2), sqrt(2)), the exp2 core a
quarter-stop reduction plus the e^y Taylor series.
"""

from __future__ import annotations

import functools
import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from .luts import EV_RESOLUTION, INT_MIN

_F32 = jnp.float32
_I32 = jnp.int32


# ---------------------------------------------------------------- double-single
# A double-single (ds) number is a pair (hi, lo) of f32 with hi = fl(hi + lo),
# carrying ~48 bits of significand. All transforms below are error-free or
# correctly bounded under IEEE round-to-nearest f32.

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    # requires |a| >= |b| (or a == 0)
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    # Dekker split at 12 bits (f32 mantissa 24 -> 2^12 + 1)
    c = jnp.float32(4097.0) * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _ds_add(xh, xl, yh, yl):
    sh, sl = _two_sum(xh, yh)
    th, tl = _two_sum(xl, yl)
    sl = sl + th
    sh, sl = _quick_two_sum(sh, sl)
    sl = sl + tl
    return _quick_two_sum(sh, sl)


def _ds_mul(xh, xl, yh, yl):
    ph, pl = _two_prod(xh, yh)
    pl = pl + (xh * yl + xl * yh)
    return _quick_two_sum(ph, pl)


def _ds_from_const(v: float):
    # np scalars, not jnp arrays: these are module-level constants that must
    # stay embeddable inside Pallas kernels (captured jax Arrays are rejected)
    hi = np.float32(v)
    lo = np.float32(v - float(hi))
    return hi, lo


def _ds_div_ff(a, b):
    """Double-single quotient of two exact f32 values.

    Self-correcting: q1 may be several ULP off (a backend may divide via a
    reciprocal); the residual r = a - q1*b is computed exactly and q2 = r/b
    restores ~2^-45 relative accuracy. A third term guards a 2-ulp-sloppy divider.
    """
    q1 = a / b
    p, perr = _two_prod(q1, b)
    s, serr = _two_sum(a, -p)
    r = s + (serr - perr)
    q2 = r / b
    p2, p2err = _two_prod(q2, b)
    r2 = ((r - p2) - p2err)
    q3 = r2 / b
    qh, ql = _quick_two_sum(q1, q2)
    ql = ql + q3
    return _quick_two_sum(qh, ql)


# ---------------------------------------------------------------- log2 core

_SQRT2_F32 = np.float32(1.4142135)  # compare threshold; either side is valid
_LOG2E_X2 = 2.0 / math.log(2.0)  # 2/ln2

# atanh-series coefficients 1/(2k+1). |t| <= 0.1716 so the t^17 tail is
# < 2e-14 of L. The t^7-and-up part of the series is evaluated in PLAIN f32
# (_ATANH_TAIL_F32, innermost-first): its magnitude is <= t^7*P ~ 6.3e-7 of
# S, so f32's ~3e-7 relative rounding contributes < 2e-13 absolute to S,
# i.e. < 2e-8 EV-index units after the 2/ln2*EVR scale — 100x inside the
# 2.5e-6 minimum boundary gap. Only the 1/3 and 1/5 terms (magnitude up to
# 1.7e-3 of S) stay in double-single. The exhaustive self-check remains the
# actual gate on every backend.
_ATANH_TAIL_F32 = [np.float32(1.0 / k) for k in (15, 13, 11, 9, 7)]
_ATANH_COEF_DS = [1.0 / 5, 1.0 / 3]


def _log2_times_evr(n):
    """floor-ready ds value of EV_RESOLUTION * log2(n) for integer n in [1, 2^24).

    Returns (hi, lo) with total relative error ~2^-45: exact mantissa/exponent
    split, t = (m-1)/(m+1) exact-ds quotient, odd atanh series in ds Horner.
    """
    f = n.astype(_F32)  # exact: n < 2^24
    bits = jax.lax.bitcast_convert_type(f, _I32)
    e = (bits >> 23) - 127
    m = jax.lax.bitcast_convert_type((bits & 0x7FFFFF) | (127 << 23), _F32)
    # normalize m to [sqrt(1/2), sqrt(2)) so |t| <= 0.1716
    red = m >= _SQRT2_F32
    e = jnp.where(red, e + 1, e)
    m = jnp.where(red, m * jnp.float32(0.5), m)
    a = m - jnp.float32(1.0)  # exact (Sterbenz, m in [0.5, 2))
    b = m + jnp.float32(1.0)  # exact (mantissa of m+1 fits 23 bits)
    th, tl = _ds_div_ff(a, b)
    t2h, t2l = _ds_mul(th, tl, th, tl)
    # t^7-and-up coefficient polynomial in plain f32 (see _ATANH_TAIL_F32)
    u = t2h
    pf = jnp.broadcast_to(_ATANH_TAIL_F32[0], th.shape)
    for c in _ATANH_TAIL_F32[1:]:
        pf = pf * u + c
    ph, pl = pf, jnp.zeros_like(pf)
    for c in _ATANH_COEF_DS:
        ph, pl = _ds_mul(ph, pl, t2h, t2l)
        ch, cl = _ds_from_const(c)
        ph, pl = _ds_add(ph, pl, ch, cl)
    # series = t + t*t2*P
    qh, ql = _ds_mul(t2h, t2l, ph, pl)
    qh, ql = _ds_mul(qh, ql, th, tl)
    sh, sl = _ds_add(th, tl, qh, ql)
    ch, cl = _ds_from_const(_LOG2E_X2)
    lh, ll = _ds_mul(sh, sl, ch, cl)
    # EVR * (e + L); scale by 2^15 is exact, e*EVR is an exact f32 integer
    evr = jnp.float32(EV_RESOLUTION)
    return _ds_add(e.astype(_F32) * evr, jnp.float32(0.0), lh * evr, ll * evr)


def _ds_floor(zh, zl):
    fh = jnp.floor(zh)
    frac = (zh - fh) + zl  # zh - fh exact; f32 rounding of +zl is ~1e-7 << gaps
    return (fh + jnp.floor(frac)).astype(_I32)


def _ds_round_half_away(zh, zl):
    """C round(): halfway away from zero. Inputs here are never exact halves
    (log2/exp2 of integers are irrational off the exact-integer cases), so
    floor(z + 0.5) on the sign-folded magnitude is identical."""
    fh = jnp.floor(zh)
    frac = (zh - fh) + zl + jnp.float32(0.5)
    return (fh + jnp.floor(frac)).astype(_I32)


# ---------------------------------------------------------------- exp2 core

# 2^(j/4) correction constants as ds pairs
_QSTEP = [_ds_from_const(2.0 ** (j / 4.0)) for j in range(4)]
_LN2 = math.log(2.0)
# e^y Taylor 1/k! down to y^9/9! (y in [0, ln2/4): tail < 1e-14 relative;
# total error ~4e-13 relative vs a 3.1e-12 minimum relative boundary gap
# in the 20-bit ev2raw table — the tightest margin of the four transforms).
# The y^6..y^9 part is evaluated in PLAIN f32 (innermost-first): its
# magnitude is <= y^6*P6 ~ 2.7e-5 of e^y, so f32's ~2e-7 relative rounding
# contributes < 8e-15 relative — 390x inside the 3.1e-12 gap. Terms through
# y^5/120 stay in double-single.
_EXP_TAIL_F32 = [np.float32(1.0 / math.factorial(k)) for k in range(9, 5, -1)]
_EXP_COEF_DS = [1.0 / math.factorial(k) for k in range(5, -1, -1)]


def _exp2_frac_ds(x):
    """ds value of 2^x for x an exact f32 multiple of 2^-15 in [0, 1)."""
    j = jnp.floor(x * jnp.float32(4.0))  # quarter index 0..3
    xr = x - j * jnp.float32(0.25)  # exact: both multiples of 2^-15
    yh, yl = _ds_mul(xr, jnp.zeros_like(xr), *_ds_from_const(_LN2))
    # y^6-and-up coefficient polynomial in plain f32 (see _EXP_TAIL_F32)
    pf = jnp.broadcast_to(_EXP_TAIL_F32[0], x.shape)
    for c in _EXP_TAIL_F32[1:]:
        pf = pf * yh + c
    ph, pl = pf, jnp.zeros_like(pf)
    for c in _EXP_COEF_DS:
        ph, pl = _ds_mul(ph, pl, yh, yl)
        ch, cl = _ds_from_const(c)
        ph, pl = _ds_add(ph, pl, ch, cl)
    # multiply by 2^(j/4) selected without a gather
    outh, outl = _ds_mul(ph, pl, *_QSTEP[0])
    for k in (1, 2, 3):
        oh, ol = _ds_mul(ph, pl, *_QSTEP[k])
        sel = j == k
        outh = jnp.where(sel, oh, outh)
        outl = jnp.where(sel, ol, outl)
    return outh, outl


def _pow2_int(q):
    """Exact f32 power of two 2^q for integer q in [-126, 127]."""
    return jax.lax.bitcast_convert_type((q + 127) << 23, _F32)


# ---------------------------------------------------------------- public 16-bit

def raw2ev16(p, black: int):
    """Arithmetic get_raw2ev (main.c:154-179): int32 EV of uint16-ish pixels.

    p may be any int dtype; result matches raw2ev_lut(black, 1<<16)[p] for
    p in [0, 65536): trunc(log2(p-black)*EVR) above black, INT_MIN at black,
    0 below.
    """
    s = p.astype(_I32) - jnp.int32(black)
    n = jnp.maximum(s, 1)
    k = _ds_floor(*_log2_times_evr(n))
    return jnp.where(s > 0, k, jnp.where(s == 0, jnp.int32(INT_MIN), 0))


def ev2raw16_pos(ev):
    """Arithmetic get_ev2raw for non-negative EV indices in [0, 14*EVR).

    Matches ev2raw_lut()[10*EVR:][ev] = trunc(2^(ev/EVR)). Caller clips the
    domain (as the LUT consumers already do).
    """
    ev = ev.astype(_I32)
    q = ev >> 15
    frac = (ev & jnp.int32(EV_RESOLUTION - 1)).astype(_F32) * jnp.float32(
        1.0 / EV_RESOLUTION
    )
    vh, vl = _exp2_frac_ds(frac)
    scale = _pow2_int(q)
    return _ds_floor(vh * scale, vl * scale)


# ---------------------------------------------------------------- public 20-bit

def raw2ev20(i, black20: int):
    """Arithmetic 20-bit raw2ev (build_ev2raw_lut, hdr.c:843-850).

    round(log2(1+|i/64-black/64|)*EVR) with the sign of the signal; the C
    clamps signal at -1023 (i.e. |s64| <= 65472 on the negative side).
    Matches luts.raw2ev_lut20 exactly for i in [0, 1<<20).
    """
    s64 = i.astype(_I32) - jnp.int32(black20)
    mag = jnp.minimum(jnp.abs(s64), jnp.where(s64 < 0, 65472, jnp.int32(2**31 - 1)))
    # log2(1 + mag/64) = log2(64 + mag) - 6
    zh, zl = _log2_times_evr(64 + mag)
    k = _ds_round_half_away(zh - jnp.float32(6 * EV_RESOLUTION), zl)
    return jnp.where(s64 > 0, k, -k)


def _round64_exp2(j):
    """round(64 * 2^(j/EVR)) for j >= 0 (exact-ds exp2, scaled by 2^6)."""
    q = j >> 15
    frac = (j & jnp.int32(EV_RESOLUTION - 1)).astype(_F32) * jnp.float32(
        1.0 / EV_RESOLUTION
    )
    vh, vl = _exp2_frac_ds(frac)
    scale = _pow2_int(q + 6)
    return _ds_round_half_away(vh * scale, vl * scale)


def ev2raw20(ev, black20: int, white20: int, white_ev: int):
    """Arithmetic 20-bit ev2raw (hdr.c:852-868) over [-10*EVR, 14*EVR).

    ``white_ev`` is raw2ev20(white20) (host scalar), for the >=white clamp
    (hdr.c:861-864). Matches luts.ev2raw_lut20 including the
    ev==raw2ev[0] -> 0 dead-pixel quirk (hdr.c:868).
    """
    ev = ev.astype(_I32)
    mag = _round64_exp2(jnp.abs(ev))
    neg = jnp.clip(jnp.int32(black20) + 64 - mag, 0, black20)
    pos = jnp.clip(jnp.int32(black20) - 64 + mag, black20, (1 << 20) - 1)
    pos = jnp.where(ev >= jnp.int32(white_ev), jnp.maximum(pos, jnp.int32(white20)), pos)
    out = jnp.where(ev < 0, neg, pos)
    # keep "bad" pixels: ev2raw[raw2ev[0]] = 0 (hdr.c:868)
    zero_ev = raw2ev20(jnp.zeros((), _I32), black20)
    return jnp.where(ev == zero_ev, 0, out)


# ---------------------------------------------------------------- verification
#
# Every public transform is a composition of INTEGER operations (shifts,
# compares, clips, wheres) around exactly four real-valued cores:
#
#   floor(EVR*log2(s))            s in [1, 65535]           (raw2ev16)
#   trunc(2^(e/EVR))              e in [0, 14*EVR)          (ev2raw16_pos)
#   round(EVR*log2(n/64))         n in [64, 64 + 2^20)      (raw2ev20)
#   round(64*2^(j/EVR))           j in [0, 14*EVR)          (ev2raw20)
#
# black/white/white_ev enter only through the integer shell, so verifying
# the four cores exhaustively proves bit-exactness for EVERY black level
# and white level at once. check_cores() does that (~2.6M values, four tiny
# device programs); self_check() runs it once per process.


def check_cores() -> None:
    """Raise AssertionError on the first core that disagrees with f64.

    Wrapped in ensure_compile_time_eval: self_check() may legitimately be
    consulted while a caller's jit is TRACING (e.g. chroma smoothing inside
    a fused pipeline program) — without it the check's own device calls
    would be inlined into the ambient trace as tracers and the comparison
    could not run (observed: silent fallback to the LUT gathers inside
    fused programs)."""
    evr = EV_RESOLUTION
    with jax.ensure_compile_time_eval():
        s = np.arange(1, 1 << 16, dtype=np.int64)
        want = np.trunc(np.log2(s.astype(np.float64)) * evr).astype(np.int32)
        got = np.asarray(_ds_floor(*_log2_times_evr(jnp.asarray(s, jnp.int32))))
        assert np.array_equal(got, want), "floor(EVR*log2) core mismatch"

        e = np.arange(14 * evr, dtype=np.int64)
        want = np.trunc(np.power(2.0, e / evr)).astype(np.int32)
        got = np.asarray(ev2raw16_pos(jnp.asarray(e, jnp.int32)))
        assert np.array_equal(got, want), "trunc(exp2) core mismatch"

        n = np.arange(64, 64 + (1 << 20), dtype=np.int64)
        want = np.round(np.log2(n / 64.0) * evr).astype(np.int32)
        zh, zl = _log2_times_evr(jnp.asarray(n, jnp.int32))
        # the -6*EVR shift is exact: 6*EVR has trailing zeros past ulp(zh)
        got = np.asarray(_ds_round_half_away(zh - jnp.float32(6 * evr), zl))
        assert np.array_equal(got, want), "round(EVR*log2) core mismatch"

        j = np.arange(14 * evr, dtype=np.int64)
        want = np.round(64 * np.power(2.0, j / evr)).astype(np.int32)
        got = np.asarray(_round64_exp2(jnp.asarray(j, jnp.int32)))
        assert np.array_equal(got, want), "round(64*exp2) core mismatch"


@functools.lru_cache(maxsize=None)
def self_check() -> bool:
    """True iff the arithmetic transforms are verified bit-exact on the live
    backend (exhaustive core check, once per process). Callers fall back to
    the LUT gathers on False, with a warning. MLVFS_TPU_EVARITH=0 forces the
    LUT path.
    """
    if os.environ.get("MLVFS_TPU_EVARITH", "1") == "0":
        return False
    try:
        check_cores()
    except AssertionError as exc:
        warnings.warn(f"evarith self-check failed ({exc}); using LUT gathers")
        return False
    return True
