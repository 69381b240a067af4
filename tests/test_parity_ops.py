"""Bit-exact parity for the stencil ops vs the compiled reference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mlvfs_tpu.format import synth
from mlvfs_tpu.format.reader import MLVClip

from . import oracle

pytestmark = pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")


def _clip_and_frame(tmp_path, seed=5, **kw):
    path = str(tmp_path / "OPS.MLV")
    kw.setdefault("width", 320)
    kw.setdefault("height", 96)
    spec = synth.write_mlv(path, seed=seed, **kw)
    clip = MLVClip(path)
    fh = clip.frame_headers(0)
    img = synth.make_frame_data(spec, np.random.default_rng(spec.seed))
    return clip, fh, spec, img


@pytest.mark.parametrize("method", [2, 3, 5])
def test_chroma_smooth_parity(tmp_path, method):
    from mlvfs_tpu.ops.chroma_smooth import chroma_smooth_batch

    clip, fh, spec, img = _clip_and_frame(tmp_path)
    ref = oracle.chroma_smooth(fh, img, method)
    ours = np.asarray(
        jax.jit(chroma_smooth_batch, static_argnums=(1, 2))(
            jnp.asarray(img[None]), method, spec.black
        )
    )[0]
    np.testing.assert_array_equal(ref, ours)


def test_chroma_smooth_black_pixels_parity(tmp_path):
    """Pixels exactly at black exercise the INT_MIN LUT entry."""
    from mlvfs_tpu.ops.chroma_smooth import chroma_smooth_batch

    clip, fh, spec, img = _clip_and_frame(tmp_path)
    img = img.copy()
    img[10:20, 10:40] = spec.black  # flat black patch
    img[30, ::3] = spec.black
    ref = oracle.chroma_smooth(fh, img, 3)
    ours = np.asarray(
        jax.jit(chroma_smooth_batch, static_argnums=(1, 2))(jnp.asarray(img[None]), 3, spec.black)
    )[0]
    np.testing.assert_array_equal(ref, ours)


def test_bad_pixel_detection_parity(tmp_path):
    from mlvfs_tpu.ops import pixels as pixel_ops

    clip, fh, spec, img = _clip_and_frame(tmp_path)
    img = img.copy()
    rng = np.random.default_rng(3)
    # inject cold + hot pixels at spread-out locations (>=4px apart so the
    # sequential-vs-parallel fix order cannot differ)
    ys = rng.choice(np.arange(10, spec.height - 10, 5), 8, replace=False)
    xs = rng.choice(np.arange(10, spec.width - 10, 5), 8, replace=False)
    for i, (y, x) in enumerate(zip(ys, xs)):
        img[y, x] = 100 if i % 2 == 0 else 16383

    ours_list = pixel_ops.detect_bad_pixels(
        img, spec.width, spec.height, spec.black, aggressive=False, crop_x=0, crop_y=0
    )
    ref_fixed = oracle.fix_bad_pixels(fh, img, aggressive=0, dual_iso=0)
    from mlvfs_tpu.ops.pixels import fix_pixel_list_batch

    ours_fixed = np.asarray(
        fix_pixel_list_batch(jnp.asarray(img[None]), ours_list, spec.black, 0, 0, dual_iso=False)
    )[0]
    np.testing.assert_array_equal(ref_fixed, ours_fixed)


def test_bad_pixel_detection_aggressive_parity(tmp_path):
    from mlvfs_tpu.ops import pixels as pixel_ops
    from mlvfs_tpu.ops.pixels import fix_pixel_list_batch

    clip, fh, spec, img = _clip_and_frame(tmp_path, seed=9)
    img = img.copy()
    img[20, 20] = 16000
    img[40, 80] = 50
    ours_list = pixel_ops.detect_bad_pixels(
        img, spec.width, spec.height, spec.black, aggressive=True, crop_x=0, crop_y=0
    )
    ref_fixed = oracle.fix_bad_pixels(fh, img, aggressive=1, dual_iso=0)
    ours_fixed = np.asarray(
        fix_pixel_list_batch(jnp.asarray(img[None]), ours_list, spec.black, 0, 0, dual_iso=False)
    )[0]
    np.testing.assert_array_equal(ref_fixed, ours_fixed)


def test_focus_pixel_fix_parity(tmp_path):
    """Focus-pixel correction with a synthetic .fpm map, both code paths."""
    from mlvfs_tpu.ops import pixels as pixel_ops
    from mlvfs_tpu.ops.pixels import fix_pixel_list_batch

    clip, fh, spec, img = _clip_and_frame(tmp_path)
    # synthetic sparse map in sensor coords (spread >= 4px apart)
    rng = np.random.default_rng(11)
    pts = [(int(x), int(y)) for x, y in zip(range(8, 300, 24), range(8, 90, 7))]
    # include edge pixels to exercise the edge interpolation branches
    pts += [(1, 50), (318, 50), (150, 1), (150, 94), (2, 2)]
    cam = int(fh.idnt["cameraModel"])
    ri = fh.raw_info
    fpm_name = "%x_%ix%i.fpm" % (cam, ri.width, ri.height)
    with open(tmp_path / fpm_name, "w") as f:
        for x, y in pts:
            f.write(f"{x} {y}\n")

    for dual_iso in (0, 1):
        ref_fixed = oracle.fix_focus_pixels(fh, img, dual_iso, cwd=str(tmp_path))
        pl = pixel_ops.load_focus_pixel_map(cam, ri.width, ri.height, str(tmp_path))
        assert pl is not None and len(pl) == len(pts)
        ours_fixed = np.asarray(
            fix_pixel_list_batch(
                jnp.asarray(img[None]), pl, spec.black, 0, 0, dual_iso=bool(dual_iso)
            )
        )[0]
        np.testing.assert_array_equal(ref_fixed, ours_fixed, err_msg=f"dual_iso={dual_iso}")


def test_pixel_fix_black_gradient_neighbors_parity(tmp_path):
    """Interpolation weights with a gradient neighbor exactly at black.

    raw2ev[black] is INT_MIN (the C casts -inf, main.c:165), so the
    ABS/sum/divide weight chain in interpolate_* runs on wrapped int32
    values and C's truncating division by a possibly NEGATIVE sum
    (cs.c:96-103,151-158). Found by tools/fuzz_oracle.py (seeds 25/29):
    guarding on sum>0 with a floor division diverged by a full
    interpolation direction. Exercises both the 4-direction and the
    dual-ISO horizontal paths."""
    from mlvfs_tpu.ops import pixels as pixel_ops
    from mlvfs_tpu.ops.pixels import fix_pixel_list_batch

    # distinct geometry: the oracle caches the first .fpm loaded per
    # (camera, crop) for the process (cs.c:421-437), and 320x96 is taken
    # by test_focus_pixel_fix_parity
    clip, fh, spec, img = _clip_and_frame(tmp_path, width=328)
    img = img.copy()
    cases = [(40, 30), (80, 30), (120, 30), (160, 50), (200, 50)]
    for i, (x, y) in enumerate(cases):
        # surround each listed pixel with black at a mix of the +-1/+-3
        # gradient offsets and the +-2 value offsets
        if i % 2 == 0:
            img[y, x + 1] = spec.black
            img[y - 1, x] = spec.black
        else:
            img[y, x - 3] = spec.black
            img[y + 3, x] = spec.black
        if i == 2:
            img[y, x + 2] = spec.black  # value neighbor at black too
    cam = int(fh.idnt["cameraModel"])
    ri = fh.raw_info
    with open(tmp_path / ("%x_%ix%i.fpm" % (cam, ri.width, ri.height)), "w") as f:
        for x, y in cases:
            f.write(f"{x} {y}\n")
    pl = pixel_ops.load_focus_pixel_map(cam, ri.width, ri.height, str(tmp_path))
    for dual_iso in (0, 1):
        ref_fixed = oracle.fix_focus_pixels(fh, img, dual_iso, cwd=str(tmp_path))
        ours_fixed = np.asarray(
            fix_pixel_list_batch(
                jnp.asarray(img[None]), pl, spec.black, 0, 0, dual_iso=bool(dual_iso)
            )
        )[0]
        np.testing.assert_array_equal(ref_fixed, ours_fixed, err_msg=f"dual_iso={dual_iso}")

