"""Device time of each op's XLA form at 1080p, batch 16, on the accelerator.

    python tools/time_ops.py [--out FILE]

For the costly ops of the conversion path (and the AMaZE raster scans
inside the demosaic) it times the jitted XLA program on device-resident
inputs, a batch of 16 frames: median of 10 calls, each ending in
block_until_ready. Beside
each time it prints the op's bytes roofline: the least bytes the op must move
(inputs read once, outputs written once) over the H100's 3.35 TB/s, and the
share of that bound the measured time reaches. Prints the device and the
card's name and power limit first; fails without an accelerator.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# device_kind substring -> peak device-memory bandwidth (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12}
H, W, BPP = 1080, 1920, 14
BATCH = 16
ITERS = 10


def _time(fn, args):
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _ops():
    """name -> (jitted fn, device args, min bytes moved per batch)."""
    import jax
    import jax.numpy as jnp

    from mlvfs_tpu.format import synth
    from mlvfs_tpu.format.bits import pack_bits_np
    from mlvfs_tpu.ops import amaze, amaze_core, dualiso, dualiso_full, evarith
    from mlvfs_tpu.ops.chroma_smooth import chroma_smooth_batch
    from mlvfs_tpu.ops.patternnoise import fix_pattern_noise_batch
    from mlvfs_tpu.ops.unpack import unpack_batch, words_for_pixels

    b = BATCH
    rng = np.random.default_rng(7)
    spec = synth.SynthSpec(width=W, height=H, frames=1, bpp=BPP)
    frame = synth.make_frame_data(spec, rng)
    imgs = jnp.asarray(np.broadcast_to(frame, (b, H, W)).copy())
    n_words = words_for_pixels(H * W, BPP)
    words = jnp.asarray(np.broadcast_to(pack_bits_np(frame.ravel(), BPP)[:n_words], (b, n_words)).copy())
    px = b * H * W
    hp, wp = H + 32, W + 32
    ppx = b * hp * wp

    cfa = jnp.asarray(np.pad(frame.astype(np.float32) / 65535.0, 16, mode="reflect"))
    cfa_b = jnp.broadcast_to(cfa, (b, hp, wp))
    cfa_b2 = jnp.broadcast_to(cfa[::-1], (b, hp, wp))
    raw_b = cfa_b[:, 16:-16, 16:-16] * 65535.0
    yy = jnp.arange(hp)[:, None]
    xx = jnp.arange(wp)[None, :]
    rbmask = ((yy + xx) % 2) == 0
    nyq = jnp.broadcast_to(((cfa * 1000).astype(jnp.int32) % 2) * rbmask, (b, hp, wp))

    ev = evarith.raw2ev16(jnp.asarray(frame, jnp.int32), spec.black)
    ev_b = jnp.broadcast_to(ev, (b, H, W))
    s_rows = jnp.where((jnp.arange(H) % 4) < 2, 1, -1).astype(jnp.int32)
    restricted = jnp.broadcast_to(jnp.asarray(frame > 9000), (b, H, W))
    alias = jnp.broadcast_to(jnp.asarray(frame.astype(np.int32) % 4096), (b, H, W))
    skip = jnp.broadcast_to(jnp.asarray(frame > 12000), (b, H, W))
    pa = jnp.full((b,), 0.125, jnp.float32)
    pb = jnp.zeros((b,), jnp.float32)
    pshadow = jnp.full((b,), 3000.0, jnp.float32)
    pdrs = jnp.zeros((b,), jnp.int32)

    per_frame = lambda f: jax.jit(jax.vmap(f))  # noqa: E731
    return {
        "unpack": (jax.jit(lambda w: unpack_batch(w, BPP, H, W)), (words,),
                   b * n_words * 2 + px * 2),
        "chroma smooth 3x3": (jax.jit(lambda x: chroma_smooth_batch(x, 3, spec.black)), (imgs,),
                              2 * px * 2),
        "pattern noise": (lambda x: fix_pattern_noise_batch(x, spec.white), (imgs,), 2 * px * 2),
        "amaze demosaic": (per_frame(amaze_core.amaze_demosaic), (raw_b,), px * 4 + 3 * px * 4),
        "amaze refine scan": (per_frame(lambda a: amaze_core._neighbor_refine_scan(a, hp, wp)),
                              (cfa_b,), 2 * ppx * 4),
        "amaze dilate scan": (per_frame(lambda a: amaze_core._nyquist_dilate(a, hp, wp)),
                              (nyq,), 2 * ppx * 4),
        "amaze chroma scan": (per_frame(lambda a, c: amaze_core._chroma_smooth_scan(a, c, hp, wp)),
                              (cfa_b, cfa_b2), 4 * ppx * 4),
        "edge pick": (per_frame(lambda e, a, c, r: amaze.edge_pick_xla(e, a, c, s_rows, r, H, W)),
                      (ev_b, ev_b, ev_b, restricted), px * (3 * 4 + 1 + 4)),
        "alias filter": (per_frame(lambda a, k: dualiso_full._alias_filter_xla(a, k, H, W)),
                         (alias, skip), px * (4 + 1 + 4)),
        "preview apply": (lambda x, a_, b_, s_, d_: dualiso.apply_preview_xla(x, a_, b_, s_, d_, spec.black, spec.white),
                          (imgs, pa, pb, pshadow, pdrs), 2 * px * 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="also write the rows as JSON here")
    args = ap.parse_args(argv)

    from mlvfs_tpu.utils.cache import enable_compile_cache
    from mlvfs_tpu.utils.device import gpu_name_and_power_limit, require_accelerator

    device = require_accelerator()
    card = gpu_name_and_power_limit().splitlines()[0]
    print(f"device: {device}; card: {card}", flush=True)
    enable_compile_cache()
    peak = next((v for k, v in PEAK_BYTES_PER_S.items() if k in device["kind"]), None)
    if peak is None:
        raise SystemExit(f"no peak bandwidth on record for {device['kind']!r}")

    rows = []
    for name, (fn, fargs, nbytes) in _ops().items():
        t = _time(fn, fargs)
        floor = nbytes / peak
        row = {
            "op": name, "batch": BATCH, "ms_per_batch": t * 1e3,
            "ms_per_frame": t * 1e3 / BATCH, "min_bytes": nbytes,
            "roofline_ms": floor * 1e3, "roofline_share": floor / t,
            "device": device["kind"], "card": card,
        }
        rows.append(row)
        print(f"{name:>20}: {row['ms_per_batch']:9.3f} ms/batch {row['ms_per_frame']:8.4f} ms/frame "
              f"bytes-roofline {row['roofline_ms']:.4f} ms = {100 * row['roofline_share']:.2f}%",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
