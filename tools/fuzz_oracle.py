"""Differential fuzz campaign vs the compiled reference oracle.

Random inputs run through our ops AND the reference C (tests/oracle/
liboracle.so, built from /root/reference) and are compared under each op's
parity contract — bit/byte-exact for the deterministic paths, the
documented tolerance where the reference is stochastic (stripes FIXP
dither). This extends the fixed-case tests in tests/test_parity_*.py to
randomized geometries, black/white levels and frame content; its purpose
is hunting rare mismatches the fixed cases cannot reach (a LUT edge at an
unusual black level, a straddling-word unpack case at an odd row length,
a header field that only renders for some metadata combination).

Run on the CPU (JAX_PLATFORMS=cpu is the default here):

    python tools/fuzz_oracle.py --iters 200 --seed 0
    python tools/fuzz_oracle.py --ops chroma,unpack --iters 50

Design notes:
- Geometries and black/white levels come from small per-run pools derived
  from --seed: every new (shape, static-arg) pair costs an XLA-CPU
  recompile, so unbounded random shapes would spend the whole campaign
  compiling. Pools move between runs (different --seed), not within one.
- The dual-ISO PSNR paths fuzz at ONE pinned geometry (1280x960, the same
  the fixed tests use, so every iteration reuses cached compiles): preview
  (op_preview), the full cr2hdr20 path (op_cr2hdr: random content, phase,
  EV gap, GBRG, amaze-edge/mean23), and preview inside the composed chain
  (op_chain). Unbounded geometries would spend the campaign compiling.
- op_chain drives the composed process_frame orchestrator (main.c:908-1005)
  through the REAL convert path end-to-end with random flag combinations:
  header bytes exact, payload bit-exact without dual-ISO, preview PSNR
  contract with it.
- Failures are deterministic to reproduce: the per-iteration rng derives
  from (--seed, iteration), so each FAIL line prints the exact re-run
  command. The campaign continues past failures; exit code 1 if any.

Reference behaviors exercised: dng.c:612-872, chroma_smooth.c, cs.c,
patternnoise.c, stripes.c, main.c:895-906 (deflicker), wav.c, gif.c,
lj92.c.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mlvfs_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()  # share the test suite's persistent compile cache

from mlvfs_tpu.format import mlv, synth  # noqa: E402
from mlvfs_tpu.format.reader import MLVClip  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from tests import oracle  # noqa: E402

class Campaign:
    def __init__(self, seed: int, workdir: str):
        self.master = np.random.default_rng(seed)
        self.workdir = workdir
        self.failures = []
        self._clips = {}
        # small per-run pools (see module docstring): geometry, levels
        g = self.master
        self.shapes = [(64, 96), (96, 320)] + [
            (int(g.integers(12, 140)) * 2, int(g.integers(16, 260)) * 2) for _ in range(3)
        ]
        self.blacks = [2048] + [int(g.integers(256, 4000)) for _ in range(2)]
        self.whites = [15000, int(g.integers(9000, 16200))]

    # one synthetic clip per (w, h, bpp, black, white): the fh feeds the
    # oracle; payload content is regenerated per iteration
    def clip(self, w, h, bpp=14, black=None, white=None, **kw):
        black = self.blacks[0] if black is None else black
        white = self.whites[0] if white is None else white
        key = (w, h, bpp, black, white, tuple(sorted(kw.items())))
        if key not in self._clips:
            path = os.path.join(self.workdir, "F%d.MLV" % len(self._clips))
            spec = synth.write_mlv(
                path, width=w, height=h, frames=1, bpp=bpp, black=black, white=white, **kw
            )
            clip = MLVClip(path)
            self._clips[key] = (clip.frame_headers(0), spec, path)
        return self._clips[key]

    def record(self, op, it, err, seed):
        # reproduction is deterministic: the per-iteration rng is
        # default_rng((seed << 20) ^ it), so (op, --seed, iter) is the repro
        repro = f"python tools/fuzz_oracle.py --ops {op} --seed {seed} --iters {it + 1}"
        self.failures.append((op, it, str(err)[:300], repro))
        print(f"FAIL {op} iter={it}: {str(err)[:200]}\n  repro: {repro}", flush=True)


def _rand_frame(rng, h, w, black, white):
    """Frame content with the hostile features: flat patches at black,
    saturated blobs, strong edges, plus broadband noise."""
    img = rng.integers(0, 16384, (h, w), dtype=np.int64)
    if rng.random() < 0.7:
        y, x = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 8))
        img[y : y + 4, x : x + 8] = black
    if rng.random() < 0.5:
        img[int(rng.integers(0, h)), :: int(rng.integers(2, 5))] = black
    if rng.random() < 0.5:
        y, x = int(rng.integers(0, h - 3)), int(rng.integers(0, w - 3))
        img[y : y + 3, x : x + 3] = white
    if rng.random() < 0.5:
        img[:, : int(rng.integers(1, w))] += int(rng.integers(500, 4000))
    return np.clip(img, 0, 16383).astype(np.uint16)


# ------------------------------- ops ---------------------------------- #


def op_dng(c: Campaign, rng, it):
    """DNG header byte parity over random metadata (dng.c:612-800)."""
    from mlvfs_tpu.emit.dng import build_dng_header

    h, w = c.shapes[int(rng.integers(len(c.shapes)))]
    cams = [
        ("Canon EOS 5D Mark III", 0x80000285),
        ("Canon EOS 7D", 0x80000250),
        ("Canon EOS M", 0x80000331),
        ("Canon EOS 700D", 0x80000326),
        ("Canon EOS Unknown", 0x80009999),  # fallback matrices
    ]
    name, model = cams[int(rng.integers(len(cams)))]
    fpss = [(24000, 1001), (25000, 1000), (30000, 1001), (50000, 1000), (2397, 100)]
    nom, den = fpss[int(rng.integers(len(fpss)))]
    kw = dict(
        camera_name=name,
        camera_model=model,
        fps_nom=nom,
        fps_denom=den,
        iso=int(rng.integers(100, 25600)),
        shutter_us=int(rng.integers(100, 40000)),
        aperture=int(rng.integers(95, 2200)),
        focal_length=int(rng.integers(8, 600)),
        kelvin=int(rng.integers(2500, 10000)),
        wb_mode=int(rng.integers(0, 7)) if rng.random() < 0.5 else mlv.WB_KELVIN,
    )
    if rng.random() < 0.3:
        ay, ax = int(rng.integers(0, 12)), int(rng.integers(0, 64))
        kw["active_area"] = (ay, ax, h, w)
    fh, spec, _ = c.clip(w, h, **kw)
    fps = float(rng.choice([0.0, 23.976, 25.0, 48.0]))
    base = "FZ%d" % int(rng.integers(0, 999999))
    ref = oracle.dng_header(fh, fps, base)
    ours = build_dng_header(fh, fps, base)
    if ref != ours:
        diff = [i for i in range(len(ref)) if ref[i] != ours[i]][:16]
        raise AssertionError(f"header differs, first bytes {diff} (kw={kw}, fps={fps})")


def op_unpack(c: Campaign, rng, it):
    """Bit-unpack parity on random word streams (dng.c:813-843)."""
    from mlvfs_tpu.ops.unpack import unpack_words, words_for_pixels

    bpp = int(rng.choice([8, 10, 12, 14]))
    h, w = c.shapes[int(rng.integers(len(c.shapes)))]
    n = h * w
    nw = words_for_pixels(n, bpp)
    words = rng.integers(0, 65536, nw, dtype=np.int64).astype(np.uint16)
    if rng.random() < 0.3:
        words[rng.integers(0, nw, nw // 7)] = 0xFFFF
    fh, _, _ = c.clip(w, h, bpp=bpp)
    ref = oracle.unpack(fh, words, n)
    ours = np.asarray(
        jax.jit(unpack_words, static_argnums=(1, 2))(jnp.asarray(words), bpp, n)
    )
    np.testing.assert_array_equal(ref, ours)


def op_chroma(c: Campaign, rng, it):
    """Chroma smoothing parity at random levels (chroma_smooth.c, cs.c:37-84)."""
    from mlvfs_tpu.ops.chroma_smooth import chroma_smooth_batch

    method = int(rng.choice([2, 3, 5]))
    h, w = c.shapes[int(rng.integers(len(c.shapes)))]
    black = c.blacks[int(rng.integers(len(c.blacks)))]
    fh, spec, _ = c.clip(w, h, black=black)
    img = _rand_frame(rng, h, w, black, spec.white)
    ref = oracle.chroma_smooth(fh, img, method)
    ours = np.asarray(
        jax.jit(chroma_smooth_batch, static_argnums=(1, 2))(jnp.asarray(img[None]), method, black)
    )[0]
    np.testing.assert_array_equal(ref, ours)


def op_pattern(c: Campaign, rng, it):
    """Pattern-noise parity on random scenes (patternnoise.c:357-379)."""
    from mlvfs_tpu.ops.patternnoise import fix_pattern_noise_batch

    h, w = c.shapes[int(rng.integers(len(c.shapes)))]
    white = c.whites[int(rng.integers(len(c.whites)))]
    img = np.full((h, w), float(rng.integers(1500, 9000)))
    img += rng.normal(0, 15, (h, w))
    img[:, 0::2] += np.repeat(rng.normal(0, 6, (w + 1) // 2), 1)[None, : img[:, ::2].shape[1]]
    img[0::2, :] += rng.normal(0, 5, ((h + 1) // 2))[: img[::2, :].shape[0], None]
    if rng.random() < 0.7:
        x = int(rng.integers(0, w - 4))
        img[:, x : x + 4] += 3000  # strong edge -> gradient mask
    if rng.random() < 0.5:
        img[int(rng.integers(0, h - 4)) :, :] += 800
    if rng.random() < 0.5:
        y, x = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 4))
        img[y : y + 4, x : x + 4] = white + 500  # near-white mask
    img = np.clip(img, 0, 16383).astype(np.uint16)
    ref = oracle.fix_pattern_noise(img.astype(np.int16), white=white).astype(np.uint16)
    ours = np.asarray(fix_pattern_noise_batch(jnp.asarray(img[None]), white))[0]
    np.testing.assert_array_equal(ref, ours)


def op_deflicker(c: Campaign, rng, it):
    """Deflicker median/EV parity (main.c:895-906)."""
    from mlvfs_tpu.ops.histogram import deflicker_median

    h, w = c.shapes[int(rng.integers(len(c.shapes)))]
    bpp = int(rng.choice([12, 14]))
    # keep a sane domain above black at 12 bpp (pool blacks reach ~4000,
    # which would collapse the [black+64, 2^bpp-256) target range)
    black = min(c.blacks[int(rng.integers(len(c.blacks)))], (1 << bpp) - 1024)
    fh, spec, _ = c.clip(w, h, bpp=bpp, black=black)
    lo = black + 16  # median must clear black (the reference's log2 domain)
    img = rng.integers(lo, (1 << bpp) - 1, (h, w), dtype=np.int64).astype(np.uint16)
    target = int(rng.integers(black + 64, (1 << bpp) - 256))
    ref_num, ref_den = oracle.deflicker(fh, target, img)
    white = (1 << bpp) + 1
    med = int(jax.jit(deflicker_median, static_argnums=(1,))(jnp.asarray(img), white))
    corr = np.log2((target - black) / float(med - black))
    got = (int(corr * 10000), 10000)
    if got != (ref_num, ref_den):
        raise AssertionError(f"deflicker {got} != ref {(ref_num, ref_den)} (med={med})")


def op_stripes(c: Campaign, rng, it):
    """Stripe calibration (tolerance: dither) + exact apply (stripes.c).

    Content is a smooth bright scene with per-column-mod-8 gain errors —
    the banding the calibration exists for. On broadband-uniform content
    the log2-ratio median is ill-conditioned: both estimators land ~2000
    FIXP units from the injected truth with a heavy-tailed mutual
    disagreement (observed up to 46), which tests the dither, not the
    port. On smooth scenes both sit ~180 from truth and disagree mean 3.6
    / max 8 over 40 cases; 16 is the contract bound (the reference's own
    apply threshold is 131 = 0.2%, stripes.c:238)."""
    from mlvfs_tpu.ops import stripes as stripes_ops

    h, w = 96, 320  # calibration needs enough highlight mass per column class
    black, white = 2048, 15000
    fh, spec, _ = c.clip(w, h)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        9000
        + 3500 * np.sin(xx / 37.0 + rng.random() * 6)
        + 2000 * np.cos(yy / 23.0)
        + rng.normal(0, 200, (h, w))
    )
    gains = 1.0 + rng.uniform(-0.02, 0.02, 8)
    gains[:2] = 1.0  # columns 0/1 are the reference pair
    img = black + (base - black) * np.tile(gains, w // 8)[None, :]
    img = np.clip(img, 0, 16383).astype(np.uint16)
    ref_fixed, ref_gains, ref_needed = oracle.stripes(fh, img, apply=True)
    ours_gains, needed = stripes_ops.compute_correction(
        img, black, white, w, frame_size_bytes=fh.raw_info.frame_size
    )
    if bool(needed) != bool(ref_needed):
        raise AssertionError(f"needed {needed} != ref {ref_needed}")
    np.testing.assert_allclose(ours_gains, ref_gains, atol=16)
    ours_fixed = np.asarray(
        stripes_ops.apply_correction_batch(
            jnp.asarray(img[None]), ref_gains.astype(np.int32), black, white
        )
    )[0]
    np.testing.assert_array_equal(ref_fixed, ours_fixed)


def _spread_points(rng, h, w, n, margin=10, min_dist=5):
    """Random points pairwise >= min_dist apart (the parity contract: the
    reference fixes pixels sequentially, so adjacent bad pixels would see
    each other's fixes — tests/test_parity_ops.py uses the same spacing)."""
    pts = []
    tries = 0
    while len(pts) < n and tries < 400:
        tries += 1
        y, x = int(rng.integers(margin, h - margin)), int(rng.integers(margin, w - margin))
        if all(abs(y - py) >= min_dist or abs(x - px) >= min_dist for py, px in pts):
            if all(abs(y - py) >= min_dist for py, px in pts if abs(x - px) < min_dist):
                pts.append((y, x))
    return pts


def op_badpix(c: Campaign, rng, it):
    """Bad-pixel detect+fix parity with random injections (cs.c:220-353).

    Contract care, learned from the first campaign run:
    - the reference caches the detected map per (fileGuid, aggressive)
      (cs.c:233-245), so the clip here gets a fresh unique GUID per
      iteration — a shared GUID makes the oracle reuse a stale map from an
      earlier iteration's image.
    - the parity contract only covers non-interacting detections: the
      reference fixes sequentially, so two detected pixels whose stencils
      overlap see each other's fixes. The base image is smooth (no natural
      detections — broadband-uniform content plus `aggressive` triggers
      hundreds of adjacent natural hits) and injections are spread >= 5 px;
      a pairwise-distance guard skips the rare residual interaction.
    """
    from mlvfs_tpu.ops import pixels as pixel_ops
    from mlvfs_tpu.ops.pixels import fix_pixel_list_batch

    h, w = c.shapes[int(rng.integers(len(c.shapes)))]
    if h < 32 or w < 32:
        return
    black = c.blacks[int(rng.integers(len(c.blacks)))]
    aggressive = bool(rng.integers(0, 2))
    path = os.path.join(c.workdir, f"B{it}.MLV")
    synth.write_mlv(
        path, width=w, height=h, frames=1, black=black,
        guid=int(rng.integers(1, 1 << 62)),
    )
    with MLVClip(path) as clip:
        fh = clip.frame_headers(0)
    # smooth base: gradient + low-sigma noise keeps natural detections at 0
    yy, xx = np.mgrid[0:h, 0:w]
    base = black + 1200 + 900 * np.sin(xx / 17.0) + 700 * np.cos(yy / 23.0)
    img = np.clip(base + rng.normal(0, 25, (h, w)), black + 500, 12000).astype(np.uint16)
    for i, (y, x) in enumerate(_spread_points(rng, h, w, int(rng.integers(2, 12)))):
        v = int(img[y, x])
        if i % 3 == 0:
            img[y, x] = int(rng.integers(0, max(1, black - 96)))  # cold
        elif i % 3 == 1:
            img[y, x] = min(16383, black + 8 * (v - black))  # hot (2 EV)
        else:
            img[y, x] = min(16383, black + int(2.5 * (v - black)))  # aggressive-only
    ours_list = pixel_ops.detect_bad_pixels(
        img, w, h, black, aggressive=aggressive, crop_x=0, crop_y=0
    )
    pts = [(int(p[0]), int(p[1])) for p in ours_list]
    for i in range(len(pts)):
        for j in range(i + 1, len(pts)):
            if abs(pts[i][0] - pts[j][0]) < 4 and abs(pts[i][1] - pts[j][1]) < 4:
                return  # interacting detections: outside the parity contract
    ref_fixed = oracle.fix_bad_pixels(fh, img, aggressive=int(aggressive), dual_iso=0)
    ours_fixed = np.asarray(
        fix_pixel_list_batch(jnp.asarray(img[None]), ours_list, black, 0, 0, dual_iso=False)
    )[0]
    np.testing.assert_array_equal(ref_fixed, ours_fixed)


def op_focus(c: Campaign, rng, it):
    """Focus-pixel map correction parity (cs.c:355-438).

    The reference caches loaded .fpm maps statically per (camera, sensor
    crop) for the life of the process (cs.c:355-362; the caller reuses the
    first load), so the map content here derives deterministically from
    the geometry — every iteration that repeats a geometry presents the
    exact map the oracle cached at its first load. The frame content stays
    random (the fix is stateless given the map)."""
    from mlvfs_tpu.ops import pixels as pixel_ops
    from mlvfs_tpu.ops.pixels import fix_pixel_list_batch

    h, w = c.shapes[int(rng.integers(len(c.shapes)))]
    if h < 32 or w < 32:
        return
    fh, spec, path = c.clip(w, h)
    map_rng = np.random.default_rng(w * 131071 + h)  # per-geometry, run-stable
    pts = [(x, y) for y, x in _spread_points(map_rng, h, w, 3 + (w + h) % 12)]
    pts += [(1, min(50, h - 2)), (w - 2, min(50, h - 2))]  # edge branches
    cam = int(fh.idnt["cameraModel"])
    ri = fh.raw_info
    fpm_dir = os.path.dirname(path)
    fpm = os.path.join(fpm_dir, "%x_%ix%i.fpm" % (cam, ri.width, ri.height))
    if not os.path.exists(fpm):  # deterministic content: write-once
        with open(fpm, "w") as f:
            for x, y in pts:
                f.write(f"{x} {y}\n")
    dual_iso = int(rng.integers(0, 2))
    img = _rand_frame(rng, h, w, spec.black, spec.white)
    ref_fixed = oracle.fix_focus_pixels(fh, img, dual_iso, cwd=fpm_dir)
    pl = pixel_ops.load_focus_pixel_map(cam, ri.width, ri.height, fpm_dir)
    assert pl is not None and len(pl) == len(pts), "map load count"
    ours_fixed = np.asarray(
        fix_pixel_list_batch(
            jnp.asarray(img[None]), pl, spec.black, 0, 0, dual_iso=bool(dual_iso)
        )
    )[0]
    np.testing.assert_array_equal(ref_fixed, ours_fixed)


def op_wav(c: Campaign, rng, it):
    """WAV byte parity on random audio clips (wav.c:189-374)."""
    from mlvfs_tpu.emit.wav import build_wav, wav_size

    w, h = 128, 32
    frames = int(rng.integers(2, 10))
    chunks = int(rng.choice([1, 1, 3]))
    rate = int(rng.choice([44100, 48000]))
    fpss = [(24000, 1001), (25000, 1000), (30000, 1001)]
    nom, den = fpss[int(rng.integers(len(fpss)))]
    path = os.path.join(c.workdir, f"W{it}.MLV")
    spec = synth.write_mlv(
        path, width=w, height=h, frames=frames, audio=True, audio_rate=rate,
        chunks=chunks, fps_nom=nom, fps_denom=den, seed=int(rng.integers(1 << 30)),
    )
    seed = int(rng.integers(1, 1 << 30))
    rand_ref = oracle.rand_after_seed(seed)
    ref = oracle.wav(path, seed=seed)
    with MLVClip(path) as clip:
        ours = build_wav(clip, rand_ref=rand_ref)
        size_ok = wav_size(clip) == len(ref)
    if not size_ok:
        raise AssertionError("wav_size mismatch")
    orig_off = 20 + 256
    defined = len(spec.camera_name.encode()) + 1
    assert len(ours) == len(ref), "length"
    assert ours[: orig_off + defined] == ref[: orig_off + defined], "head"
    assert ours[orig_off + 32 :] == ref[orig_off + 32 :], "body"


def op_gif(c: Campaign, rng, it):
    """GIF preview byte parity on random clips (gif.c:82-234)."""
    from mlvfs_tpu.emit.gif import build_gif, gif_size

    shapes = [(64, 96), (64, 256)]
    h, w = shapes[int(rng.integers(len(shapes)))]
    frames = int(rng.integers(1, 15))
    black = c.blacks[int(rng.integers(len(c.blacks)))]
    path = os.path.join(c.workdir, f"G{it}.MLV")
    synth.write_mlv(
        path, width=w, height=h, frames=frames, black=black, seed=int(rng.integers(1 << 30))
    )
    with MLVClip(path) as clip:
        fh = clip.frame_headers(0)
        ref = oracle.gif(path, fh)
        ours = build_gif(clip)
        assert gif_size(fh.xres, fh.yres) == len(ref), "gif_size"
    if ours != ref:
        diff = [i for i in range(min(len(ours), len(ref))) if ours[i] != ref[i]][:8]
        raise AssertionError(f"gif differs at {diff} (len {len(ours)} vs {len(ref)})")


def op_lj92(c: Campaign, rng, it):
    """LJ92 interop at <=14 bits; ours-roundtrip at 16 (lj92.c).

    Cross-direction interop only runs at bit depths the reference handles
    per spec. At 16 bits with high-entropy content, SSSS class 16 occurs
    (diff == 32768, coded with NO extra bits, T.81 H.2): the reference's
    encoder keeps `int sssshist[16]` (lj92.c:60 — class 16 overflows it;
    heap corruption observed in this campaign) and neither its encoder nor
    decoder implements the no-extra-bits special case, so 16-bit interop
    with lj92.c is undefined, not a parity target. MLV camera streams are
    <=14 bit. Our codec implements the spec case on both sides and is
    gated here by its own 16-bit roundtrip on the same hostile content.
    """
    from mlvfs_tpu.codecs import lj92

    h, w = int(rng.integers(8, 120)), int(rng.integers(16, 200)) * 2
    bits = int(rng.choice([10, 12, 14, 16]))
    kind = rng.random()
    if kind < 0.3:
        img = np.full((h, w), int(rng.integers(0, 1 << bits)), np.uint16)  # flat
    elif kind < 0.6:
        img = rng.integers(0, 1 << bits, (h, w)).astype(np.uint16)  # broadband
    else:
        img = (np.cumsum(rng.integers(-3, 4, (h, w)), axis=1) % (1 << bits)).astype(np.uint16)
    if bits == 16:
        dec, dw, dh, db, dn = lj92.decode(lj92.encode(img, ncomp=1, bits=16))
        np.testing.assert_array_equal(dec.reshape(h, w), img, err_msg="ours 16-bit roundtrip")
        return
    dec, dw, dh, dbits = oracle.lj92_decode(lj92.encode(img, ncomp=1, bits=bits))
    np.testing.assert_array_equal(dec.reshape(h, w), img, err_msg="ours->ref")
    dec2, *_ = lj92.decode(oracle.lj92_encode(img, bitdepth=bits))
    np.testing.assert_array_equal(dec2.reshape(h, w), img, err_msg="ref->ours")


def op_preview(c: Campaign, rng, it):
    """Dual-ISO preview vs the reference, random phase/EV/content (hdr.c:40-227).

    Fixed 1280x960 geometry: the reference's CDF walk is bounded by the
    sample count (hdr.c:127), so smaller frames make the C fit itself
    degenerate — see tests/test_parity_dualiso_preview.py. Gates mirror
    that test: detection agrees, levels x4, <2% differing pixels and
    PSNR > 60 dB (both sides compute the fit in different float widths)."""
    from mlvfs_tpu.ops import dualiso

    phase = int(rng.integers(0, 4))
    ev = int(rng.choice([2, 3, 4, 5]))
    spec = synth.SynthSpec(
        width=1280, height=960, frames=1, seed=int(rng.integers(1 << 30)),
        dual_iso=ev, dual_iso_phase=phase,
    )
    img = synth.make_frame_data(spec, np.random.default_rng(spec.seed))
    path = os.path.join(c.workdir, f"P{it}.MLV")
    synth.write_mlv(path, spec, frame_data=img[None])
    with MLVClip(path) as clip:
        fh = clip.frame_headers(0)
    ref, ok, ref_black, ref_white = oracle.hdr_preview(fh, img)
    assert ok, "oracle did not detect the dual-ISO pattern"
    assert (ref_black, ref_white) == (spec.black * 4, spec.white * 4)
    out, ok_mask = dualiso.hdr_preview_batch(jnp.asarray(img[None]), fh, None)
    assert bool(ok_mask[0]), f"our detection rejected phase={phase} ev={ev}"
    ours = np.asarray(out)[0]
    mismatched = (ref != ours).mean()
    assert mismatched < 0.02, f"{mismatched:.4f} of pixels differ (phase={phase} ev={ev})"
    mse = np.mean((ref.astype(np.float64) - ours.astype(np.float64)) ** 2)
    psnr = np.inf if mse == 0 else 10 * np.log10(65535.0**2 / mse)
    assert psnr > 60, f"PSNR {psnr:.1f} dB (phase={phase} ev={ev})"


def op_cr2hdr(c: Campaign, rng, it):
    """Dual-ISO full path (cr2hdr20) vs the reference at a pinned geometry
    (hdr.c:1774-1930), randomized content/phase/EV/GBRG/interpolator.

    1280x960 is pinned so every iteration reuses the compiles the fixed
    tests already cached (the full path costs minutes per geometry on XLA
    CPU); content, interlacing phase, exposure gap, Bayer order and the
    interpolator (amaze-edge / mean23) all randomize. Gates mirror
    tests/test_parity_dualiso_full.py / test_parity_amaze.py: PSNR > 55
    (mean23; 45 for the no-fullres f32 curve case) / > 60 (amaze-edge)."""
    from mlvfs_tpu.ops import dualiso_full
    from mlvfs_tpu.pipeline.config import ProcessingConfig

    interp = int(rng.integers(0, 2))  # 0=amaze-edge, 1=mean23
    fullres, alias, cs = 1, 1, 0
    if interp == 1 and rng.random() < 0.5:
        # mean23 option combos from the fixed tests (each already compiled)
        fullres, alias, cs = [(0, 1, 0), (1, 0, 0), (1, 1, 3), (0, 0, 5)][
            int(rng.integers(4))
        ]
    spec = synth.SynthSpec(
        width=1280, height=960, frames=1, seed=int(rng.integers(1 << 30)),
        dual_iso=int(rng.choice([2, 3, 4, 5])), dual_iso_phase=int(rng.integers(0, 4)),
        gbrg=bool(rng.integers(0, 2)),
    )
    img = synth.make_frame_data(spec, np.random.default_rng(spec.seed))
    path = os.path.join(c.workdir, f"CR{it}.MLV")
    synth.write_mlv(path, spec, frame_data=img[None])
    with MLVClip(path) as clip:
        fh = clip.frame_headers(0)
    with oracle.capture_c_stdout():  # the C logs its analysis (hdr.c:622,820)
        ref, ok, bl, wl = oracle.cr2hdr20(
            fh, img, interp=interp, fullres=fullres, alias_map=alias, cs_method=cs
        )
    assert ok, f"oracle rejected dual-ISO (phase={spec.dual_iso_phase} ev={spec.dual_iso})"
    assert (bl, wl) == (spec.black * 4, spec.white * 4)
    cfg = ProcessingConfig(
        dual_iso=2, hdr_interpolation_method=interp,
        hdr_no_fullres=not fullres, hdr_no_alias_map=not alias, chroma_smooth=cs,
    )
    out, okm = dualiso_full.cr2hdr20_batch(jnp.asarray(img[None]), fh, cfg, None)
    assert bool(np.asarray(okm)[0]), (
        f"our detection rejected phase={spec.dual_iso_phase} ev={spec.dual_iso} gbrg={spec.gbrg}"
    )
    ours = np.asarray(out)[0]
    mse = np.mean((ref.astype(np.float64) - ours.astype(np.float64)) ** 2)
    psnr = np.inf if mse == 0 else 10 * np.log10(65535.0**2 / mse)
    bound = 60 if interp == 0 else (45 if not fullres else 55)
    assert psnr > bound, (
        f"PSNR {psnr:.1f} dB (interp={interp} fullres={fullres} alias={alias} cs={cs} "
        f"phase={spec.dual_iso_phase} ev={spec.dual_iso} gbrg={spec.gbrg})"
    )


CHAIN_CAM = 0x99775533  # chain-only camera id: the reference's focus-map
#   cache is static first-load-wins per (camera, crop) (cs.c:421), so the
#   chain owns a camera no other op touches and always provides its map


def _chain_focus_map(c: Campaign, w, h):
    """Deterministic per-geometry .fpm for the chain camera (write-once)."""
    map_rng = np.random.default_rng(w * 131071 + h + 7)
    pts = [(x, y) for y, x in _spread_points(map_rng, h, w, 3 + (w + h) % 10)]
    fpm = os.path.join(c.workdir, "%x_%ix%i.fpm" % (CHAIN_CAM, w, h))
    if not os.path.exists(fpm):
        with open(fpm, "w") as f:
            for x, y in pts:
                f.write(f"{x} {y}\n")
    return pts


def _chain_convert(path, cfg, outdir, inject=None):
    """Run our real conversion engine on the clip; returns (dng, calibration).

    ``inject``: optional (gains, needed) preset for the stripe calibration —
    used to pin the reference's dithered gains so the downstream apply can be
    compared byte-for-byte (the gains themselves are compared under the
    op_stripes tolerance contract separately)."""
    from mlvfs_tpu.pipeline.convert import ClipConverter

    with MLVClip(path) as clip:
        conv = ClipConverter(clip, cfg)
        try:
            if inject is not None:
                cal = conv._get_calibration()
                cal.stripes_gains = np.asarray(inject[0], np.int32)
                cal.stripes_needed = bool(inject[1])
                cal.stripes_done = True
            paths = conv.convert(outdir)
            cal = conv._calibration
        finally:
            conv.close()
    with open(paths[0], "rb") as f:
        return f.read(), cal


def op_chain(c: Campaign, rng, it):
    """Composed process_frame chain vs the reference (main.c:908-1005).

    Random flag combinations through the full convert path — decode,
    deflicker, pattern noise, dual-ISO preview (+header redo), the per-frame
    else-branch, chroma, stripes — compared end-to-end on the emitted DNG:
    header bytes exact always; payload bit-exact without dual-ISO, under the
    preview PSNR contract with it. Stripe gains are pinned to the
    reference's dithered values for the byte compare and separately checked
    under the op_stripes tolerance; our gains come from the same pipeline
    position (the fully processed first frame, main.c:980-996)."""
    from mlvfs_tpu.pipeline.config import ProcessingConfig

    dual = 1 if rng.random() < 0.3 else 0
    if dual:
        # preview-fit geometry (see op_preview); also keeps the header-redo
        # quirk moot (2*w*h >= 65536, main.c:963)
        h, w = 960, 1280
        black, white = 2048, 15000
    else:
        h, w = c.shapes[int(rng.integers(len(c.shapes)))]
        if h < 32 or w < 32:
            return
        black = c.blacks[int(rng.integers(len(c.blacks)))]
        white = c.whites[int(rng.integers(len(c.whites)))]
    flags = dict(
        deflicker=int(rng.choice([0, 0, black + 512 + int(rng.integers(0, 6000))])),
        pattern=int(rng.integers(0, 2)),
        dual_iso=dual,
        chroma=0 if dual and rng.random() < 0.5 else int(rng.choice([0, 2, 3, 5])),
        bad_pix=0 if dual else int(rng.choice([0, 0, 1, 2])),
        stripes=int(rng.integers(0, 2)) if w % 8 == 0 else 0,
    )

    pts = _chain_focus_map(c, w, h)
    if dual:
        spec = synth.SynthSpec(
            width=w, height=h, frames=1, seed=int(rng.integers(1 << 30)),
            dual_iso=int(rng.choice([2, 3, 4])), dual_iso_phase=int(rng.integers(0, 4)),
            camera_model=CHAIN_CAM, guid=int(rng.integers(1, 1 << 62)),
            black=black, white=white,
        )
        img = synth.make_frame_data(spec, np.random.default_rng(spec.seed))
    else:
        spec = synth.SynthSpec(
            width=w, height=h, frames=1, camera_model=CHAIN_CAM,
            guid=int(rng.integers(1, 1 << 62)), black=black, white=white,
        )
        # smooth base (the bad-pixel contract needs no natural detections)
        yy, xx = np.mgrid[0:h, 0:w]
        base = black + 1400 + 1000 * np.sin(xx / 19.0 + rng.random() * 6) + 800 * np.cos(yy / 27.0)
        if flags["stripes"] and rng.random() < 0.7:
            gains = 1.0 + rng.uniform(-0.02, 0.02, 8)
            gains[:2] = 1.0
            base = black + (base - black) * np.tile(gains, w // 8)[None, :]
        img = np.clip(base + rng.normal(0, 20, (h, w)), 0, 16383).astype(np.uint16)
        if flags["bad_pix"]:
            inj = _spread_points(rng, h, w, int(rng.integers(2, 8)))
            # keep injections clear of the focus map (focus fixes run first;
            # a bad pixel inside a focus stencil is still parity-safe, but
            # a bad pixel AT a focus point would be fixed away pre-detection)
            inj = [p for p in inj if all(abs(p[0] - y) + abs(p[1] - x) > 2 for x, y in pts)]
            for i, (y, x) in enumerate(inj):
                v = int(img[y, x])
                if i % 2:
                    img[y, x] = int(rng.integers(0, max(1, black - 96)))
                else:
                    img[y, x] = min(16383, black + 8 * max(1, v - black))

    path = os.path.join(c.workdir, f"CH{it}.MLV")
    synth.write_mlv(path, spec, frame_data=img[None])
    with MLVClip(path) as clip:
        fh = clip.frame_headers(0)
    base_name = f"CH{it}"

    with oracle.capture_c_stdout():  # the C dumps detected bad pixels (cs.c:307)
        ref_img, ref_header, ref_dual, ref_gains, ref_needed = oracle.process_frame(
            fh, img, deflicker=flags["deflicker"], fps=0.0, basename=base_name,
            pattern=flags["pattern"], dual_iso=flags["dual_iso"],
            chroma=flags["chroma"], bad_pix=flags["bad_pix"],
            stripes=flags["stripes"], cwd=c.workdir,
        )
    # ref_dual may legitimately be False on dual content: pattern noise runs
    # BEFORE dual-ISO in the chain (main.c:946-959) and can break the
    # preview detection. The parity contract is that we match the
    # reference's per-frame decision — verified below by the header compare
    # (x4 levels present or not) and the payload contract that applies.

    cfg = ProcessingConfig(
        deflicker=flags["deflicker"], fix_pattern_noise=bool(flags["pattern"]),
        dual_iso=flags["dual_iso"], chroma_smooth=flags["chroma"],
        fix_bad_pixels=flags["bad_pix"], fix_stripes=bool(flags["stripes"]),
        focus_pixel_dir=c.workdir, batch_size=1, use_sidecar_idx=False,
    )
    outdir = os.path.join(c.workdir, f"chain{it}")
    dng, cal = _chain_convert(path, cfg, outdir)

    if flags["bad_pix"] and cal.bad_pixel_list is not None:
        bl = [(int(p[0]), int(p[1])) for p in cal.bad_pixel_list]
        for i in range(len(bl)):
            for j in range(i + 1, len(bl)):
                if abs(bl[i][0] - bl[j][0]) < 4 and abs(bl[i][1] - bl[j][1]) < 4:
                    return  # interacting detections: outside the parity contract

    if flags["stripes"]:
        if not ref_dual:  # converted inputs differ at PSNR level: skip gains check
            if bool(cal.stripes_needed) != ref_needed:
                raise AssertionError(
                    f"stripes needed {cal.stripes_needed} != ref {ref_needed} ({flags})"
                )
            if ref_needed:
                np.testing.assert_allclose(
                    np.asarray(cal.stripes_gains), ref_gains, atol=16,
                    err_msg=f"stripe gains ({flags})",
                )
        # pin the reference's dithered gains for the byte compare
        dng, _ = _chain_convert(
            path, cfg, os.path.join(c.workdir, f"chain{it}b"),
            inject=(ref_gains, ref_needed),
        )

    header, payload = dng[:65536], np.frombuffer(dng[65536:], "<u2").reshape(h, w)
    if header != ref_header:
        diff = [i for i in range(65536) if header[i] != ref_header[i]][:12]
        raise AssertionError(f"header differs at {diff} ({flags})")
    if not ref_dual:  # no conversion ran: the whole chain is deterministic
        np.testing.assert_array_equal(payload, ref_img, err_msg=f"payload ({flags})")
    else:
        mismatched = (ref_img != payload).mean()
        assert mismatched < 0.02, f"{mismatched:.4f} of pixels differ ({flags})"
        mse = np.mean((ref_img.astype(np.float64) - payload.astype(np.float64)) ** 2)
        psnr = np.inf if mse == 0 else 10 * np.log10(65535.0**2 / mse)
        assert psnr > 60, f"PSNR {psnr:.1f} dB ({flags})"


OPS = {
    "dng": op_dng,
    "unpack": op_unpack,
    "chroma": op_chroma,
    "pattern": op_pattern,
    "deflicker": op_deflicker,
    "stripes": op_stripes,
    "badpix": op_badpix,
    "focus": op_focus,
    "wav": op_wav,
    "gif": op_gif,
    "lj92": op_lj92,
    "preview": op_preview,
    "chain": op_chain,
    "cr2hdr": op_cr2hdr,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ops", type=str, default=",".join(OPS))
    args = ap.parse_args()

    if not oracle.available():
        print("reference oracle unavailable (build with tests/oracle/build.sh)")
        return 2

    ops = [o for o in args.ops.split(",") if o]
    unknown = set(ops) - set(OPS)
    if unknown:
        print(f"unknown ops: {sorted(unknown)}; available: {sorted(OPS)}")
        return 2

    t0 = time.time()
    counts = {o: 0 for o in ops}
    with tempfile.TemporaryDirectory(prefix="fuzz_oracle_") as workdir:
        c = Campaign(args.seed, workdir)
        print(f"pools: shapes={c.shapes} blacks={c.blacks} whites={c.whites}", flush=True)
        for it in range(args.iters):
            op = ops[it % len(ops)]
            rng = np.random.default_rng((args.seed << 20) ^ it)
            try:
                OPS[op](c, rng, it)
                counts[op] += 1
            except Exception as e:  # noqa: BLE001 — record and continue
                c.record(op, it, e, args.seed)
            if (it + 1) % 25 == 0:
                print(f"[{it + 1}/{args.iters}] {time.time() - t0:.0f}s {counts}", flush=True)
    ok = not c.failures
    print(
        f"done: {args.iters} iters in {time.time() - t0:.0f}s, "
        f"{sum(counts.values())} comparisons, {len(c.failures)} failures"
    )
    for op, it, err, path in c.failures:
        print(f"  {op} iter={it}: {err} ({path})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
