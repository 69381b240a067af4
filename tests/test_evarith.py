"""Exhaustive bit-exactness gates for the gather-free EV transforms.

These are not sampled tests: every value of every finite input domain is
compared against the f64-built reference tables (ops/luts.py, themselves
oracle-gated), so a pass PROVES the arithmetic forms equal the tables on
this backend. The 20-bit transforms are additionally checked against full
tables for several (black, white) pairs to exercise the integer shell
around the verified cores.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mlvfs_tpu.ops import evarith
from mlvfs_tpu.ops.luts import (
    EV_RESOLUTION,
    raw2ev_lut,
    ev2raw_lut,
    raw2ev_lut20,
    ev2raw_lut20,
)


def test_core_self_check_passes():
    evarith.self_check.cache_clear()
    try:
        assert evarith.self_check() is True
    finally:
        evarith.self_check.cache_clear()


@pytest.mark.parametrize("black", [0, 1, 2047, 2048, 8191, 16383])
def test_raw2ev16_exhaustive(black):
    p = jnp.arange(1 << 16, dtype=jnp.int32)
    got = np.asarray(jax.jit(lambda v: evarith.raw2ev16(v, black))(p))
    want = np.asarray(raw2ev_lut(black, size=1 << 16))
    np.testing.assert_array_equal(got, want)


def test_ev2raw16_exhaustive():
    e = jnp.arange(14 * EV_RESOLUTION, dtype=jnp.int32)
    got = np.asarray(jax.jit(evarith.ev2raw16_pos)(e))
    want = np.asarray(ev2raw_lut())[10 * EV_RESOLUTION :]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "black20,white20",
    [(2048 * 64, 15000 * 64), (1791 * 64, 16200 * 64), (0, 65535 * 64)],
)
def test_luts20_exhaustive(black20, white20):
    i = jnp.arange(1 << 20, dtype=jnp.int32)
    got = np.asarray(jax.jit(lambda v: evarith.raw2ev20(v, black20))(i))
    want = np.asarray(raw2ev_lut20(black20, white20))
    np.testing.assert_array_equal(got, want)

    wev = int(want[min(white20, (1 << 20) - 1)])
    e = jnp.arange(-10 * EV_RESOLUTION, 14 * EV_RESOLUTION, dtype=jnp.int32)
    got2 = np.asarray(
        jax.jit(lambda v: evarith.ev2raw20(v, black20, white20, wev))(e)
    )
    want2 = np.asarray(ev2raw_lut20(black20, white20))
    np.testing.assert_array_equal(got2, want2)


def test_self_check_inside_trace():
    """self_check must succeed while a caller's jit is tracing (fused
    pipeline programs call chroma smoothing under jit) — regression for the
    silent LUT fallback observed in the fused bench."""
    import warnings as _w

    evarith.self_check.cache_clear()
    try:
        from mlvfs_tpu.ops.chroma_smooth import chroma_smooth_batch

        imgs = jnp.zeros((1, 16, 32), jnp.uint16)
        with _w.catch_warnings():
            _w.simplefilter("error")  # the fallback warns — make that fatal
            jax.jit(lambda x: chroma_smooth_batch(x, 3, 2048))(imgs)
        assert evarith.self_check() is True
    finally:
        evarith.self_check.cache_clear()


@pytest.mark.parametrize("method", [2, 3, 5])
def test_chroma_arith_matches_luts(method):
    """Chroma smoothing through the arithmetic EV transforms equals the LUT
    gathers bit for bit, black pixels (the INT_MIN case) included."""
    from mlvfs_tpu.ops import chroma_smooth as cs

    black = 2048
    rng = np.random.default_rng(method)
    imgs = rng.integers(black - 40, 16383, (2, 24, 40), dtype=np.uint16)
    imgs[:, ::7, ::5] = black
    imgs = jnp.asarray(imgs)
    lut, inv = cs._luts16(black)
    want = cs._cs_jit(imgs, method, jnp.asarray(lut), jnp.asarray(inv), jnp.int32(black))
    got = cs._cs_jit_arith(imgs, method, black)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
