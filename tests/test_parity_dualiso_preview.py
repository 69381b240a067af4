"""Dual-ISO preview path vs the reference (PSNR-bounded + structural parity)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mlvfs_tpu.format import synth
from mlvfs_tpu.format.reader import MLVClip
from mlvfs_tpu.ops import dualiso

from . import oracle

pytestmark = pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")


def _dual_clip(tmp_path, phase=0, ev=3, seed=17):
    # The reference's CDF walk is bounded by the SAMPLE COUNT (hdr.c:127,
    # raw_hi < hist_total), so the histogram fit only sees values below
    # ~count. Real sensors (1808x1190+) give counts above the white level;
    # anything much smaller makes the reference itself produce a degenerate
    # NaN fit. 1280x960 is the smallest realistic geometry (count ~15.4k).
    spec = synth.SynthSpec(
        width=1280, height=960, frames=1, seed=seed, dual_iso=ev, dual_iso_phase=phase
    )
    rng = np.random.default_rng(spec.seed)
    img = synth.make_frame_data(spec, rng)
    path = str(tmp_path / "DI.MLV")
    synth.write_mlv(path, spec, frame_data=img[None])
    clip = MLVClip(path)
    return clip.frame_headers(0), spec, img


def _psnr(a, b, peak=65535.0):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak * peak / mse)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_preview_parity(tmp_path, phase):
    fh, spec, img = _dual_clip(tmp_path, phase=phase)
    ref, ok, ref_black, ref_white = oracle.hdr_preview(fh, img)
    assert ok, "oracle did not detect dual-ISO pattern"
    assert (ref_black, ref_white) == (spec.black * 4, spec.white * 4)

    out, ok_mask = dualiso.hdr_preview_batch(jnp.asarray(img[None]), fh, None)
    assert ok_mask[0]
    ours = np.asarray(out)[0]

    # identical detection and near-identical reconstruction (the fit and the
    # row transform are float; the reference computes in double)
    mismatched = (ref != ours).mean()
    assert mismatched < 0.02, f"{mismatched:.4f} of pixels differ"
    assert _psnr(ref, ours) > 60


def test_preview_rejects_non_dual(tmp_path):
    fh, spec, img = _dual_clip(tmp_path, ev=0)
    ref, ok, _, _ = oracle.hdr_preview(fh, img)
    out, ok_mask = dualiso.hdr_preview_batch(jnp.asarray(img[None]), fh, None)
    assert not ok
    assert not ok_mask[0]
    np.testing.assert_array_equal(np.asarray(out)[0], img)


def test_preview_fit_values_match(tmp_path):
    """Phase detection and histogram medians must match the reference path."""
    fh, spec, img = _dual_clip(tmp_path, phase=0)
    hists, counts = dualiso.green_phase_histograms(jnp.asarray(img[None]), spec.white)
    fits = dualiso.fit_preview(np.asarray(hists), counts, spec.black, spec.white)
    assert fits[0].ok
    assert fits[0].dark_row_start == 0
    # bright rows are ~2^3 brighter; fitted gain darkens them: a ≈ 1/8
    assert 0.06 < fits[0].a < 0.25


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_preview_fit_device_matches_host(tmp_path, phase):
    """The device fit (ops/dualiso_preview_dev.py) must agree with the host
    np/f64 path: phase detection exact, gain/offset to double-single
    accuracy, shadow to the same truncated integer."""
    from mlvfs_tpu.ops import dualiso_preview_dev as pdev

    fh, spec, img = _dual_clip(tmp_path, phase=phase)
    imgs = jnp.asarray(np.stack([img, img]))
    hists, counts = dualiso.green_phase_histograms(imgs, spec.white)
    fits = dualiso.fit_preview(np.asarray(hists), counts, spec.black, spec.white)
    ok, a, b, shadow, drs = jax.device_get(
        pdev.preview_fit_device(imgs, spec.black, spec.white)
    )
    for i, f in enumerate(fits):
        assert bool(ok[i]) == f.ok
        if not f.ok:
            continue
        assert int(drs[i]) == f.dark_row_start
        assert abs(float(a[i]) - f.a) <= 1e-5 * max(abs(f.a), 1e-3), (a[i], f.a)
        assert abs(float(b[i]) - f.b) <= 1e-3 * max(abs(f.b), 1.0), (b[i], f.b)
        assert abs(int(shadow[i]) - f.shadow) <= 1, (shadow[i], f.shadow)


def test_preview_fit_device_small_geometry_and_mixed_batch(tmp_path):
    """Walk edge cases: a geometry whose sample count sits far below the
    white level (the reference's `raw_hi < hist_total` loop bound, hdr.c:127,
    then truncates the fit's bin range — the device walk keeps the quirk via
    its `bin < total` gate), a flat non-dual frame in the same batch (no
    accepted points -> neutral-gain fallback, phase not detected), and a
    dual frame alongside them. Device fit must agree with the host f64 fit
    frame-for-frame."""
    import dataclasses

    from mlvfs_tpu.ops import dualiso_preview_dev as pdev

    spec = synth.SynthSpec(width=640, height=192, frames=1, seed=5, dual_iso=3)
    rng = np.random.default_rng(spec.seed)
    dual = synth.make_frame_data(spec, rng)
    flat = np.full_like(dual, spec.black + 7)
    plain = synth.make_frame_data(
        dataclasses.replace(spec, dual_iso=0), np.random.default_rng(9)
    )
    imgs = jnp.asarray(np.stack([dual, flat, plain]))

    hists, counts = dualiso.green_phase_histograms(imgs, spec.white)
    fits = dualiso.fit_preview(np.asarray(hists), counts, spec.black, spec.white)
    ok, a, b, shadow, drs = jax.device_get(
        pdev.preview_fit_device(imgs, spec.black, spec.white)
    )
    assert fits[0].ok, "dual frame must be detected at small geometry"
    for i, f in enumerate(fits):
        assert bool(ok[i]) == f.ok, (i, ok[i], f.ok)
        if not f.ok:
            continue
        assert int(drs[i]) == f.dark_row_start
        assert np.isfinite(f.a) == np.isfinite(float(a[i]))
        if np.isfinite(f.a):
            assert abs(float(a[i]) - f.a) <= 1e-5 * max(abs(f.a), 1e-3), (a[i], f.a)
            assert abs(float(b[i]) - f.b) <= 1e-3 * max(abs(f.b), 1.0), (b[i], f.b)
            assert abs(int(shadow[i]) - f.shadow) <= 1, (shadow[i], f.shadow)

