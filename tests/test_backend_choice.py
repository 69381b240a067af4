"""Backend choice: with JAX reporting a GPU backend, every op of the
conversion path traces to plain XLA — no Pallas kernel of any route —
and the dual-ISO preview makes no host round trip. Checked on the
CPU through jax.make_jaxpr."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlvfs_tpu.ops import amaze_core, dualiso, dualiso_full
from mlvfs_tpu.ops.chroma_smooth import chroma_smooth_batch
from mlvfs_tpu.ops.patternnoise import fix_pattern_noise_batch
from mlvfs_tpu.ops.unpack import unpack_batch, words_for_pixels

B, H, W = 2, 64, 96
BLACK, WHITE = 2048, 15000


def _imgs():
    rng = np.random.default_rng(3)
    return jnp.asarray(rng.integers(BLACK, WHITE, (B, H, W), dtype=np.uint16))


def _reconstruct(interp_method, use_alias):
    def run(imgs):
        hh = imgs.shape[1]
        rows = (jnp.arange(hh) % 4) < 2
        per_frame = [jnp.ones(B, jnp.float32)] * 2 + [jnp.full(B, WHITE * 64, jnp.int32)] + [
            jnp.zeros(B, jnp.float32), jnp.ones(B, jnp.float32)]
        return dualiso_full.reconstruct_batch(
            imgs, jnp.broadcast_to(rows, (B, hh)), jnp.ones((B, hh), jnp.int32), *per_frame,
            jnp.zeros(1, jnp.int32), jnp.zeros(10 * 32768 + 1, jnp.int32), jnp.zeros(1, jnp.float32),
            black20=BLACK * 64, white20=WHITE * 64, interp_method=interp_method,
            use_fullres=True, use_alias=use_alias, cs_method=0, exact_luts=False,
            white_ev=130000, arith=True,
        )

    return run


_FH = types.SimpleNamespace(
    raw_info=types.SimpleNamespace(black_level=BLACK, white_level=WHITE),
    vidf={"panPosX": 0, "panPosY": 0},
)

CASES = {
    "unpack": lambda imgs: unpack_batch(
        jnp.zeros((B, words_for_pixels(H * W, 14)), jnp.uint16), 14, H, W),
    "amaze": lambda imgs: jax.vmap(amaze_core.amaze_demosaic)(imgs.astype(jnp.float32)),
    "chroma smooth": lambda imgs: chroma_smooth_batch(imgs, 3, BLACK),
    "pattern noise": lambda imgs: fix_pattern_noise_batch(imgs, WHITE),
    "edge pick": _reconstruct(interp_method=0, use_alias=False),
    "alias map": _reconstruct(interp_method=1, use_alias=True),
    "preview apply": lambda imgs: dualiso.apply_preview_xla(
        imgs, jnp.ones(B), jnp.zeros(B), jnp.zeros(B), jnp.zeros(B, jnp.int32), BLACK, WHITE),
    "preview fit": lambda imgs: dualiso.hdr_preview_batch(imgs, _FH, None),
}


def _pallas_calls(jaxpr):
    """Every pallas_call in a jaxpr, nested ones included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            found.append(eqn)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found += _pallas_calls(sub)
    return found


@pytest.mark.parametrize("op", sorted(CASES))
def test_gpu_backend_traces_plain_xla(op, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    jax.clear_caches()  # jit caches traces by argument types, not by backend
    try:
        jaxpr = jax.make_jaxpr(CASES[op])(_imgs())
    finally:
        jax.clear_caches()
    assert _pallas_calls(jaxpr.jaxpr) == []
    assert "mosaic" not in str(jaxpr).lower()
    # the preview fit runs on the device: no host callback mid-batch
    assert "callback" not in str(jaxpr)
