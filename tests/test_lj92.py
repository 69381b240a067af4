"""LJ92 codec: roundtrips, reference interop, MLV decode, compressed DNG."""

import os
import struct

import numpy as np
import pytest

from mlvfs_tpu.codecs import lj92
from mlvfs_tpu.format import synth
from mlvfs_tpu.format.reader import MLVClip
from mlvfs_tpu.pipeline.config import ProcessingConfig
from mlvfs_tpu.pipeline.convert import convert_clip
from mlvfs_tpu.emit.dng import HEADER_SIZE

from . import oracle

pytestmark = pytest.mark.skipif(not lj92.available(), reason="native codec unavailable")


def _image(rng, h=240, w=320, peak=16383):
    base = peak * 0.3 + peak * 0.2 * np.sin(np.arange(w) / 23.0)[None, :]
    return np.clip(base + rng.normal(0, 30, (h, w)), 0, peak).astype(np.uint16)


@pytest.mark.parametrize("ncomp,bits", [(1, 14), (1, 16), (2, 16), (2, 14)])
def test_roundtrip(rng, ncomp, bits):
    img = _image(rng, peak=(1 << bits) - 1)
    enc = lj92.encode(img, ncomp=ncomp, bits=bits)
    dec, w, h, b, nc = lj92.decode(enc)
    assert (w * nc, h, b, nc) == (img.shape[1], img.shape[0], bits, ncomp)
    np.testing.assert_array_equal(dec, img)


def test_roundtrip_ssss16(rng):
    """16-bit content whose row-start/neighbor diffs hit SSSS class 16
    (diff == 32768 mod 2^16, coded with NO extra bits per T.81 H.2).
    The reference lj92.c cannot represent this class (sssshist[16]
    overflows; no special case in either direction), so this is gated as
    our own roundtrip — see tools/fuzz_oracle.py op_lj92."""
    for img in (
        rng.integers(0, 65536, (64, 128)).astype(np.uint16),
        (np.indices((32, 64)).sum(0) % 2 * 32768).astype(np.uint16),
        (np.arange(64 * 128, dtype=np.uint32).reshape(64, 128) * 32768 % 65536).astype(
            np.uint16
        ),
    ):
        dec, w, h, b, nc = lj92.decode(lj92.encode(img, ncomp=1, bits=16))
        np.testing.assert_array_equal(dec, img)


@pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")
def test_interop_with_reference(rng):
    img = _image(rng)
    # our encoder → reference decoder
    dec, w, h, bits = oracle.lj92_decode(lj92.encode(img, ncomp=1, bits=14))
    np.testing.assert_array_equal(dec, img)
    # reference encoder → our decoder
    dec2, *_ = lj92.decode(oracle.lj92_encode(img, bitdepth=14))
    np.testing.assert_array_equal(dec2, img)


def test_lj92_mlv_clip_converts(tmp_path):
    src = str(tmp_path / "LJ.MLV")
    spec = synth.write_mlv(src, width=256, height=64, frames=2, compression="lj92")
    clip = MLVClip(src)
    assert clip.frame_headers(0).compression == "lj92"
    outdir = str(tmp_path / "out")
    paths = convert_clip(src, outdir, ProcessingConfig())
    expected = synth.make_frame_data(spec, np.random.default_rng(spec.seed))
    img = np.fromfile(paths[0], "<u2", offset=HEADER_SIZE).reshape(64, 256)
    np.testing.assert_array_equal(img, expected)


def test_compressed_dng_output(tmp_path):
    src = str(tmp_path / "C.MLV")
    spec = synth.write_mlv(src, width=256, height=64, frames=2)
    outdir = str(tmp_path / "out")
    paths = convert_clip(src, outdir, ProcessingConfig(compress="lj92"))
    expected = synth.make_frame_data(spec, np.random.default_rng(spec.seed))

    raw = open(paths[0], "rb").read()
    # parse the TIFF: Compression must be 7, strip decodes losslessly
    (n,) = struct.unpack_from("<H", raw, 8)
    tags = {}
    for i in range(n):
        tag, typ, cnt, val = struct.unpack_from("<HHII", raw, 10 + 12 * i)
        tags[tag] = val
    assert tags[259] == 7  # ccJPEG
    strip_size = tags[279]
    assert HEADER_SIZE + strip_size == len(raw)
    assert strip_size < expected.nbytes  # actually compressed
    dec, w, h, bits, nc = lj92.decode(raw[HEADER_SIZE:])
    assert nc == 2 and w * nc == 256 and h == 64
    np.testing.assert_array_equal(dec, expected)


def test_decode_rejects_corrupt_streams_without_crashing(rng):
    """Bounds hardening (ADVICE r1): truncated/corrupt LJ92 streams must
    fail with ValueError, never read out of bounds. Covers: segments whose
    declared length runs past the buffer, truncation at every marker
    boundary, random byte flips, and oversized DHT symbol counts."""
    img = rng.integers(0, 1 << 14, size=(32, 64), dtype=np.uint16)
    stream = bytearray(lj92.encode(img, ncomp=1, bits=14))

    def try_decode(b):
        try:
            lj92.decode(bytes(b), max_pixels=1 << 16)
        except ValueError:
            pass

    # truncate at every prefix length up to the scan data (covers marker
    # fields straddling EOF) and a sweep of suffix truncations
    for n in range(len(stream))[:200]:
        try_decode(stream[:n])
    for n in range(1, 64):
        try_decode(stream[:-n])
    # inflate each segment length field so it points past the buffer
    ix = 2
    while ix + 3 < len(stream):
        if stream[ix] != 0xFF or stream[ix + 1] == 0xD9:
            break
        mutated = bytearray(stream)
        mutated[ix + 2] = 0xFF
        mutated[ix + 3] = 0xFF
        try_decode(mutated)
        seglen = (stream[ix + 2] << 8) | stream[ix + 3]
        if stream[ix + 1] == 0xDA:
            break
        ix += 2 + seglen
    # DHT with symbol counts larger than the segment
    dht_ix = bytes(stream).find(b"\xff\xc4")
    mutated = bytearray(stream)
    for i in range(16):
        mutated[dht_ix + 5 + i] = 0xFF
    try_decode(mutated)
    # SOS component table ids out of range
    sos_ix = bytes(stream).find(b"\xff\xda")
    mutated = bytearray(stream)
    mutated[sos_ix + 5] = 0xF0
    try_decode(mutated)
    # random byte flips across the whole stream
    for _ in range(300):
        mutated = bytearray(stream)
        for pos in rng.integers(0, len(stream), size=4):
            mutated[pos] = int(rng.integers(0, 256))
        try_decode(mutated)
    # pure garbage
    for _ in range(50):
        try_decode(rng.integers(0, 256, size=int(rng.integers(0, 512)), dtype=np.uint8).tobytes())


def test_decode_batch_matches_single(rng):
    """The threaded native batch decode must agree with per-frame decode and
    isolate corrupt frames (zeroed slice + nonzero rc, rest intact)."""
    imgs = [rng.integers(0, 1 << 14, size=(24, 48), dtype=np.uint16) for _ in range(5)]
    streams = [lj92.encode(im, ncomp=1, bits=14) for im in imgs]
    out, rcs = lj92.decode_batch(streams, 24 * 48)
    assert list(rcs) == [0] * 5
    for i, im in enumerate(imgs):
        single, w, h, bits, ncomp = lj92.decode(streams[i], max_pixels=24 * 48)
        np.testing.assert_array_equal(out[i].reshape(24, 48), im)
        np.testing.assert_array_equal(out[i], single.ravel())
    # corrupt one stream mid-batch
    bad = bytearray(streams[2]); bad[10:20] = b"\x00" * 10
    out2, rcs2 = lj92.decode_batch(
        [streams[0], streams[1], bytes(bad), streams[3], streams[4]], 24 * 48
    )
    assert rcs2[0] == 0 and rcs2[4] == 0
    np.testing.assert_array_equal(out2[0].reshape(24, 48), imgs[0])
    np.testing.assert_array_equal(out2[4].reshape(24, 48), imgs[4])
    if rcs2[2] != 0:
        assert out2[2].max() == 0
    # empty batch
    out3, rcs3 = lj92.decode_batch([], 16)
    assert out3.shape == (0, 16) and rcs3.shape == (0,)


def test_encode_batch_matches_single(rng):
    """Threaded native batch encode must be byte-identical to per-frame
    encode (each frame builds its own optimal Huffman table)."""
    imgs = np.stack([
        rng.integers(0, 1 << 16, size=(24, 64), dtype=np.uint16) for _ in range(4)
    ])
    batch = lj92.encode_batch(imgs, ncomp=2, bits=16)
    for i in range(4):
        assert batch[i] == lj92.encode(imgs[i], ncomp=2, bits=16)
    assert lj92.encode_batch(imgs[:0], ncomp=2) == []


@pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")
def test_decode_ff_at_refill_boundary():
    """Crafted stream whose first 8 entropy bytes contain no 0x00 but end in
    a stuffed 0xFF: a bulk-refill fast path that only screens for zero bytes
    consumes the 0xFF as data and then reads its stuffing 0x00 as data —
    regression for exactly that. Compared against the reference decoder."""
    import struct

    w, h, bits = 16, 2, 16
    # DHT: one symbol, SSSS=15, code '0' at length 1
    dht = bytes([0x00]) + bytes([1] + [0] * 15) + bytes([15])
    sof = bytes([bits]) + struct.pack(">HH", h, w) + bytes([1, 0, 0x11, 0])
    sos = bytes([1, 0, 0x00, 0x01, 0x00, 0x00])

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    # samples: '0' + 15 extra bits each (SSSS=15). Choose the first four so
    # the entropy bytes are 2A AA 2A AA 2A AA 05 FF (00) ... — no zero byte
    # in the first window, 0xFF as its last byte.
    vals = [0x2AAA, 0x2AAA, 0x2AAA, 0x02FF] + [0x2AAA] * (w * h - 4)
    bitstr = "".join("0" + format(v, "015b") for v in vals)
    by = bytearray()
    for i in range(0, len(bitstr), 8):
        chunk = bitstr[i : i + 8].ljust(8, "1")
        b = int(chunk, 2)
        by.append(b)
        if b == 0xFF:
            by.append(0x00)
    stream = (
        bytes([0xFF, 0xD8])
        + seg(0xC4, dht)
        + seg(0xC3, sof)
        + seg(0xDA, sos)
        + bytes(by)
        + bytes([0xFF, 0xD9])
    )
    assert by[6] != 0 and by[7] == 0xFF and 0 not in by[:8]

    ref_img, rw, rh, rbits = oracle.lj92_decode(stream)
    out, rcs = lj92.decode_batch([stream], w * h)
    assert rcs[0] == 0
    np.testing.assert_array_equal(out.reshape(h, w), ref_img)


def test_library_name_keys_on_source_and_flags(tmp_path):
    src = tmp_path / "lj92.cpp"
    src.write_text("int f() { return 1; }\n")
    flags = ("-O2", "-fPIC", "-shared")
    a = lj92.library_path(str(src), flags)
    assert a == lj92.library_path(str(src), flags)
    assert lj92.library_path(str(src), flags + ("-g",)) != a
    src.write_text("int f() { return 2; }\n")
    assert lj92.library_path(str(src), flags) != a
    assert os.path.dirname(a) == str(tmp_path)
    # a library left under the old unkeyed name is never the one loaded
    assert os.path.basename(lj92.library_path()) != "liblj92.so"


def test_loaded_library_is_built_from_the_source(tmp_path):
    import ctypes
    import shutil

    src = tmp_path / "lj92.cpp"
    shutil.copy(lj92._SRC, src)
    path = lj92.library_path(str(src))
    assert not os.path.exists(path)
    lj92._build(str(src), path)
    assert os.path.exists(path)
    assert hasattr(ctypes.CDLL(path), "lj92_encode_buf")
    assert lj92._load()._name == lj92.library_path()
