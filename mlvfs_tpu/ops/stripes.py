"""Vertical stripe (column banding) correction.

5D3/7D highlight banding: some columns (period 8) have slightly different
gain. Calibration compares each column against columns 0/1 via log2-ratio
histograms and takes the median ratio; correction is a per-column-mod-8
multiply applied to sufficiently bright pixels.

Reference: stripes_compute_correction (stripes.c:143-248) — computed from the
first frame of a clip only — and stripes_apply_correction (stripes.c:250-266).

Host/device split: calibration is a once-per-clip host reduction (vectorized NumPy
histograms; the reference itself only ever runs it on frame 0); application
runs on device for every frame as an exact fixed-point multiply. The
reference applies the gain in double precision then truncates — reproduced
here exactly with 32-bit integer arithmetic (the double is exact for these
magnitudes), so the per-frame path is bit-identical and needs no float64 on the
device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

FIXP_ONE = 65536
FIXP_RANGE = 65536


def compute_correction(
    frame,
    black: int,
    white: int,
    width: int,
    frame_size_bytes: int = None,
    rng: np.random.Generator = None,
):
    """Per-column-mod-8 fixed-point gains from one frame.

    Returns (gains[8] int32, needed bool). Gain 0 means "not enough data,
    leave column untouched" (the apply step checks for 0, stripes.c:261).

    The reference adds +/-0.5 uniform dither to defeat quantization spikes
    using libc rand(); we use a seeded generator — the median over thousands
    of samples is insensitive to the dither realization.
    """
    img = np.asarray(frame, np.int64)
    h, w = img.shape
    if frame_size_bytes is None:
        frame_size_bytes = w * h * 14 // 8
    if rng is None:
        rng = np.random.default_rng(0x57A1BE5)

    p = img - black
    starts = np.arange(0, w - 10, 8)
    if len(starts) == 0:
        return np.zeros(8, np.int32), False

    cols = {k: p[:, starts + k].ravel().astype(np.float64) for k in range(10)}

    # (offset, ref_col, cur_col, multiplicity) — stripes.c:175-203:
    # nearer reference pixels get higher multiplicity
    combos = [
        (2, 0, 2, 3), (2, 8, 2, 1),
        (3, 1, 3, 3), (3, 9, 3, 1),
        (4, 0, 4, 2), (4, 8, 4, 2),
        (5, 1, 5, 2), (5, 9, 5, 2),
        (6, 0, 6, 1), (6, 8, 6, 3),
        (7, 1, 7, 1), (7, 9, 7, 3),
    ]

    hist = np.zeros((8, FIXP_RANGE), np.int64)
    num = np.zeros(8, np.int64)
    too_bright = white / 1.5
    for offset, ra, rb, mult in combos:
        a, b = cols[ra], cols[rb]
        valid = (np.minimum(a, b) >= 32) & (np.maximum(a, b) <= too_bright)
        av, bv = a[valid], b[valid]
        n = len(av)
        if n == 0:
            continue
        for _ in range(mult):
            af = av + rng.integers(0, 1024, n) / 1024.0 - 0.5
            bf = bv + rng.integers(0, 1024, n) / 1024.0 - 0.5
            ev = np.log2(af / bf)
            buckets = np.clip(
                np.trunc(FIXP_RANGE / 2 + ev * (FIXP_RANGE / 2)).astype(np.int64),
                0,
                FIXP_RANGE - 1,
            )
            hist[offset] += np.bincount(buckets, minlength=FIXP_RANGE)
            num[offset] += n

    gains = np.zeros(8, np.int64)
    for j in range(2, 8):
        if num[j] < frame_size_bytes // 128:
            continue
        cum = np.cumsum(hist[j])
        k = int(np.searchsorted(cum, num[j] // 2))  # first k with cum >= num/2
        ev = (k - FIXP_RANGE / 2) / (FIXP_RANGE / 2)
        gains[j] = int(2.0**ev * FIXP_ONE)
    gains[0] = gains[1] = FIXP_ONE

    needed = bool(np.any((gains != 0) & (np.abs(gains / FIXP_ONE - 1.0) > 0.002)))
    return gains.astype(np.int32), needed


@functools.partial(jax.jit, static_argnums=(3,))
def calibrate_batch_device(imgs, black, white, frame_size_bytes: int):
    """Sharded multi-frame stripe calibration — the mesh-native upgrade of
    compute_correction (stripes.c:143-248).

    The reference calibrates from frame 0 only "for speed reasons"
    (stripes.c:97-99); on a device mesh the whole first batch participates:
    each chip computes log2-ratio statistics over its frame shard and the
    per-offset medians come from 17 bisection rounds whose counts reduce
    over the sharded frame axis — GSPMD inserts the ICI all-reduces
    (`psum`) for every cross-shard sum below. Opt-in via
    ProcessingConfig.stripes_batch_cal: medians over B frames differ from
    the reference's single-frame values by design (more robust, not
    bit-parity; the apply step stays bit-exact either way).

    Dither is omitted: the quantization spikes it defeats average out over
    thousands of samples per frame times the batch.

    Returns (gains[8] int32, needed bool_scalar).
    """
    b, h, w = imgs.shape
    nb = w // 8
    p = imgs.astype(jnp.float32).reshape(b, h, nb, 8) - black
    # column k of block i; refs 8/9 are columns 0/1 of block i+1. Blocks with
    # start >= w-10 are excluded like the C loop bound (stripes.c:175).
    n_use = min((w - 10 + 7) // 8, nb - 1)
    cur = p[:, :, :n_use, :]
    nxt = p[:, :, 1 : n_use + 1, :2]
    too_bright = white / 1.5

    combos = [
        (2, ("cur", 0), 3), (2, ("nxt", 0), 1),
        (3, ("cur", 1), 3), (3, ("nxt", 1), 1),
        (4, ("cur", 0), 2), (4, ("nxt", 0), 2),
        (5, ("cur", 1), 2), (5, ("nxt", 1), 2),
        (6, ("cur", 0), 1), (6, ("nxt", 0), 3),
        (7, ("cur", 1), 1), (7, ("nxt", 1), 3),
    ]

    buckets = []
    for offset, (which, rc), mult in combos:
        a = cur[..., rc] if which == "cur" else nxt[..., rc]
        bcol = cur[..., offset]
        valid = (jnp.minimum(a, bcol) >= 32) & (jnp.maximum(a, bcol) <= too_bright)
        ev = jnp.log2(jnp.maximum(a, 1e-9) / jnp.maximum(bcol, 1e-9))
        bk = jnp.clip(
            jnp.trunc(FIXP_RANGE / 2 + ev * (FIXP_RANGE / 2)), 0, FIXP_RANGE - 1
        ).astype(jnp.int32)
        buckets.append((offset, bk, valid, mult))

    gains = [FIXP_ONE, FIXP_ONE]
    needed = jnp.zeros((), bool)
    for j in range(2, 8):
        js = [(bk, v, m) for (o, bk, v, m) in buckets if o == j]
        num = sum(m * jnp.sum(v, dtype=jnp.int32) for (bk, v, m) in js)
        lo = jnp.zeros((), jnp.int32)
        hi = jnp.full((), FIXP_RANGE, jnp.int32)
        for _ in range(17):
            mid = (lo + hi) >> 1
            cnt = sum(
                m * jnp.sum(v & (bk <= mid), dtype=jnp.int32) for (bk, v, m) in js
            )
            take = cnt >= (num + 1) // 2
            hi = jnp.where(take, mid, hi)
            lo = jnp.where(take, lo, mid + 1)
        ev = (lo.astype(jnp.float32) - FIXP_RANGE / 2) / (FIXP_RANGE / 2)
        g = jnp.trunc(jnp.exp2(ev) * FIXP_ONE).astype(jnp.int32)
        enough = num >= b * (frame_size_bytes // 128)
        g = jnp.where(enough, g, 0)
        gains.append(g)
        needed = needed | (
            (g != 0) & (jnp.abs(g.astype(jnp.float32) / FIXP_ONE - 1.0) > 0.002)
        )
    return jnp.stack([jnp.asarray(g, jnp.int32) for g in gains]), needed


@jax.jit
def _apply(imgs, col_gains, black, white):
    p = imgs.astype(jnp.int32)
    sig = (p - black).astype(jnp.uint32)
    ch = (col_gains >> 16).astype(jnp.uint32)
    cl = (col_gains & 0xFFFF).astype(jnp.uint32)
    # exact floor((p-black)*c / 65536): high part is integral, low part shifts
    scaled = sig * ch + ((sig * cl) >> 16)
    corrected = jnp.minimum(white.astype(jnp.uint32), scaled + black.astype(jnp.uint32))
    active = (col_gains != 0) & (p > black + 64)
    return jnp.where(active, corrected, p.astype(jnp.uint32)).astype(imgs.dtype)


def apply_correction_batch(imgs: jnp.ndarray, gains: jnp.ndarray, black: int, white: int):
    """Apply gains to a batch (B, H, W); no-op unless width % 8 == 0.

    Bit-exact integer reformulation of stripes_apply_correction
    (stripes.c:250-266): result = min(white, trunc((p - black) * gain/65536)
    + black) for pixels above black + 64 in columns with nonzero gain.
    """
    w = imgs.shape[-1]
    if w % 8 != 0:
        return imgs
    col_gains = jnp.tile(jnp.asarray(gains, jnp.int32), w // 8)
    return _apply(imgs, col_gains, jnp.int32(black), jnp.int32(white))
