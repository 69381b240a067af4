"""Chroma smoothing (2x2 / 3x3 / 5x5) as a fused stencil over Bayer cells.

Algorithm (reference template chroma_smooth.c, instantiated in cs.c:37-47 for
uint16 and hdr.c:1488-1500 for the 20-bit path): for every 2x2 Bayer cell,
compute the median of (R−G) and (B−G) in EV space over the surrounding cells
(5/9/25 of them), and reapply those chroma offsets to the cell's mean green.

Device mapping: one whole-frame raw->EV table lookup (the only gather), then
the per-cell neighborhood loop unrolls into K static strided slices of the
EV image; the median is a sort over the K-axis; the conditional writes are
reshape interleaves + masked selects (no scatters). Everything fuses into
one XLA program and vmaps over the batch.

Bit-exactness: C int32 arithmetic truncates division toward zero and the
raw→EV LUT maps pixel==black to INT_MIN (cast of -inf); both reproduced here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import evarith
from .luts import EV_RESOLUTION, raw2ev_lut, ev2raw_lut

# neighborhood cell offsets per method (chroma_smooth.c:1-16,41-48)
def _offsets(method: int):
    m = 4 if method == 5 else 2
    offs = []
    for i in range(-m, m + 1, 2):
        for j in range(-m, m + 1, 2):
            if method == 2 and abs(i) + abs(j) == 4:
                continue
            offs.append((i, j))
    return offs


def _div2_trunc(t):
    """C-style (a)/2 for int32: truncation toward zero."""
    return t // 2 + ((t & 1) != 0) * (t < 0)


def chroma_smooth_image(
    img: jnp.ndarray,
    method: int,
    ev_of,
    inv_of,
    black: int,
):
    """One frame. ``ev_of(pixels)`` maps raw->EV; ``inv_of(ev)`` maps a
    non-negative EV in [0, 14*EVR) back to raw (black added here).

    The transforms are callables so callers choose between LUT gathers and
    the gather-free evarith forms (both bit-exact)."""
    h, w = img.shape
    offs = _offsets(method)
    x0, y0 = 4, 4
    # cell grid: x in [4, w-4) step 2, y in [4, h-5) step 2 (template:26-28)
    nx = max(0, (w - 4 - x0 + 1) // 2)
    ny = max(0, (h - 5 - y0 + 1) // 2)
    if nx == 0 or ny == 0:
        return img

    src = img.astype(jnp.int32)
    # one whole-frame raw->EV transform; every neighbor read below is a slice
    # of it (the transform commutes with slicing — 38 per-neighbor transforms
    # collapse to one)
    E = ev_of(src)

    # The neighborhood loop needs 3 strided (2,2) slices per offset. All
    # cell offsets are even, so four Bayer-phase planes (one strided slice
    # each) turn every neighbor read into a unit-stride slice of a phase
    # plane — the per-offset cost collapses to (almost) free views.
    def _phase(a, dy, dx):
        return jax.lax.slice(a, (dy, dx), (a.shape[0], a.shape[1]), (2, 2))

    E_ph = {(dy, dx): _phase(E, dy, dx) for dy in (0, 1) for dx in (0, 1)}
    src_ph = {(0, 0): _phase(src, 0, 0), (1, 1): _phase(src, 1, 1)}

    def cells_of(planes, dy, dx):
        # (y0+dy+2c, x0+dx+2c') = phase (dy&1, dx&1) at cell offset
        # ((y0+dy)//2, (x0+dx)//2); y0=x0=4 and all dy/dx here keep the
        # offsets integral
        p = planes[(dy & 1, dx & 1)]
        cy = (y0 + dy) >> 1
        cx = (x0 + dx) >> 1
        return jax.lax.slice(p, (cy, cx), (cy + ny, cx + nx))

    def cells(dy, dx):
        return cells_of(src_ph, dy, dx)

    def ev_cells(dy, dx):
        return cells_of(E_ph, dy, dx)

    g1c = ev_cells(0, 1)
    g2c = ev_cells(1, 0)
    ge = _div2_trunc(g1c + g2c)

    med_r = []
    med_b = []
    for (i, j) in offs:
        r = ev_cells(j, i)
        g1 = ev_cells(j, i + 1)
        g2 = ev_cells(j + 1, i)
        b = ev_cells(j + 1, i + 1)
        gen = _div2_trunc(g1 + g2)
        med_r.append(r - gen)
        med_b.append(b - gen)
    # exact K//2-order statistic via a Devillard median-selection network
    # (ops/medians.py) — value-identical to jnp.sort(stack)[k//2], proven
    # exhaustively in tests/test_medians.py, at ~1/4 the min/max ops
    from .medians import median_planes

    dr = median_planes(med_r)
    db = median_planes(med_b)

    ok = ge >= 2 * EV_RESOLUTION  # template:35 — skip dark cells
    ok &= ge + dr > EV_RESOLUTION  # template:64-65
    ok &= ge + db > EV_RESOLUTION

    def to_raw(e):
        return inv_of(jnp.clip(e, 0, 14 * EV_RESOLUTION - 1)) + black

    out_r = jnp.where(ok, to_raw(ge + dr), cells(0, 0)).astype(img.dtype)
    out_b = jnp.where(ok, to_raw(ge + db), cells(1, 1)).astype(img.dtype)

    # write back via reshape interleave + masked select instead of strided
    # scatters (a lane interleave + two wheres)
    z = jnp.zeros_like(out_r)
    spread_r = jnp.stack([jnp.stack([out_r, z], -1).reshape(ny, 2 * nx),
                          jnp.zeros((ny, 2 * nx), img.dtype)], 1).reshape(2 * ny, 2 * nx)
    spread_b = jnp.stack([jnp.zeros((ny, 2 * nx), img.dtype),
                          jnp.stack([z, out_b], -1).reshape(ny, 2 * nx)], 1).reshape(2 * ny, 2 * nx)
    pad_cfg = ((y0, h - y0 - 2 * ny, 0), (x0, w - x0 - 2 * nx, 0))
    full_r = jax.lax.pad(spread_r, jnp.array(0, img.dtype), pad_cfg)
    full_b = jax.lax.pad(spread_b, jnp.array(0, img.dtype), pad_cfg)
    yy = jax.lax.broadcasted_iota(jnp.int32, img.shape, 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, img.shape, 1)
    in_y = (yy >= y0) & (yy < y0 + 2 * ny)
    in_x = (xx >= x0) & (xx < x0 + 2 * nx)
    r_site = in_y & in_x & ((yy - y0) % 2 == 0) & ((xx - x0) % 2 == 0)
    b_site = in_y & in_x & ((yy - y0) % 2 == 1) & ((xx - x0) % 2 == 1)
    out = jnp.where(r_site, full_r, img)
    out = jnp.where(b_site, full_b, out)
    return out


@functools.lru_cache(maxsize=8)
def _luts16(black: int):
    lut = np.asarray(raw2ev_lut(black, size=1 << 16))
    inv = np.asarray(ev2raw_lut())[10 * EV_RESOLUTION :]
    return lut, inv


# LUTs passed as runtime args (not closure constants) — baking half-megabyte
# tables into the HLO slows compilation by an order of magnitude.
@functools.partial(jax.jit, static_argnums=(1,))
def _cs_jit(imgs, method, lut, inv, black):
    def ev_of(x):
        return lut[jnp.clip(x, 0, lut.shape[0] - 1)]

    def inv_of(e):
        return inv[e]

    return jax.vmap(lambda im: chroma_smooth_image(im, method, ev_of, inv_of, black))(imgs)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _cs_jit_arith(imgs, method, black):
    def ev_of(x):
        return evarith.raw2ev16(x, black)

    return jax.vmap(
        lambda im: chroma_smooth_image(im, method, ev_of, evarith.ev2raw16_pos, black)
    )(imgs)


def chroma_smooth_batch(imgs: jnp.ndarray, method: int, black: int) -> jnp.ndarray:
    """Batch (B, H, W) uint16 chroma smoothing (chroma_smooth, cs.c:49-84).

    Uses the gather-free arithmetic EV transforms (exhaustively verified
    bit-exact at first use; see ops/evarith.py) and falls back to the LUT
    gathers if the live backend ever fails the self-check.
    """
    if method not in (2, 3, 5):
        raise ValueError(f"unsupported chroma smooth method {method}")
    if evarith.self_check():
        return _cs_jit_arith(imgs, method, int(black))
    lut, inv = _luts16(black)
    return _cs_jit(imgs, method, jnp.asarray(lut), jnp.asarray(inv), jnp.int32(black))
