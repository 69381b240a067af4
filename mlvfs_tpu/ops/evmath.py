"""Computed EV transforms — the fast-path alternative to LUT gathers.

The reference's 20-bit raw↔EV tables (build_ev2raw_lut, hdr.c:839-874) are
pure log2/exp2 curves, so the transform can be computed per pixel with
log2/exp2 instead of gathered from the 4 MB table.

Values match the integer tables up to f32 rounding of the final round();
the dual-ISO path's parity gate is PSNR, and the parity suite exercises
both modes. Exact tables remain available (ProcessingConfig.exact_luts).
"""

from __future__ import annotations

import jax.numpy as jnp

from .luts import EV_RESOLUTION


def raw2ev20(i, black20: int):
    """round(log2(1 + |i/64 - black/64|) * EVR) * sign (hdr.c:843-850)."""
    signal = jnp.maximum(i.astype(jnp.float32) / 64.0 - black20 / 64.0, -1023.0)
    mag = jnp.round(jnp.log2(1.0 + jnp.abs(signal)) * EV_RESOLUTION)
    return jnp.where(signal > 0, mag, -mag).astype(jnp.int32)


def ev2raw20(ev, black20: int, white20: int, white_ev: int):
    """Inverse transform with the black offset + white clamp (hdr.c:852-865).

    ``white_ev`` is raw2ev(white20) (a host scalar), used for the >=white
    clamp rule.
    """
    evf = ev.astype(jnp.float32)
    pos = jnp.clip(
        black20 - 64.0 + jnp.round(64.0 * jnp.exp2(evf / EV_RESOLUTION)),
        black20,
        float((1 << 20) - 1),
    )
    pos = jnp.where(ev >= white_ev, jnp.maximum(pos, float(white20)), pos)
    neg = jnp.clip(
        black20 + 64.0 - jnp.round(64.0 * jnp.exp2(-evf / EV_RESOLUTION)),
        0.0,
        float(black20),
    )
    out = jnp.where(ev < 0, neg, pos)
    # table quirk: ev2raw[raw2ev[0]] = 0 keeps fully-dead pixels (hdr.c:868)
    zero_ev = raw2ev20(jnp.zeros((), jnp.int32), black20)
    out = jnp.where(ev == zero_ev, 0.0, out)
    return out.astype(jnp.int32)


def fullres_weight(i, black20: int):
    """Fullres mixing curve (build_fullres_curve, hdr.c:890-913)."""
    fullres_start, fullres_transition = 4.0, 4.0
    ev2 = jnp.log2(jnp.maximum(i.astype(jnp.float32) / 64.0 - black20 / 64.0, 1.0))
    c2 = -jnp.cos(
        jnp.clip(ev2 - fullres_start, 0, fullres_transition) * (jnp.pi / fullres_transition)
    )
    return (c2 + 1.0) * 0.5
