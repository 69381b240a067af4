"""ctypes wrapper around the compiled reference oracle (see build.sh).

Gives the test suite direct access to the reference C implementations of the
deterministic pipeline stages, for bit-exact comparisons against the
JAX implementations.
"""

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "liboracle.so")
_REF = os.environ.get("MLVFS_REFERENCE", "/root/reference/mlvfs")


def available() -> bool:
    if os.path.exists(_LIB_PATH):
        return True
    if not os.path.isdir(_REF):
        return False
    try:
        subprocess.run(["sh", os.path.join(_DIR, "build.sh")], check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, OSError):
        return False


_lib = None


def lib():
    global _lib
    if _lib is None:
        if not available():
            raise RuntimeError("oracle not available")
        _lib = ctypes.CDLL(_LIB_PATH)
        _lib.oracle_sizeof_frame_headers.restype = ctypes.c_size_t
        _lib.oracle_dng_header.restype = ctypes.c_size_t
        _lib.oracle_unpack.restype = ctypes.c_size_t
    return _lib


def pack_frame_headers(fh) -> bytearray:
    """Serialize a mlvfs_tpu FrameHeaders into the C struct layout."""
    L = lib()
    size = L.oracle_sizeof_frame_headers()
    offs = (ctypes.c_int * 10)()
    L.oracle_frame_headers_offsets(offs)
    buf = bytearray(size)

    def put(off, data):
        buf[off : off + len(data)] = data

    put(offs[0], np.uint32(fh.file_number).tobytes())
    put(offs[1], np.uint64(fh.position).tobytes())
    put(offs[2], fh.vidf.tobytes())
    put(offs[3], fh.mlvi.tobytes())
    put(offs[4], fh.rtci.tobytes())
    put(offs[5], fh.idnt.tobytes())
    put(offs[6], fh.rawi.tobytes())
    put(offs[7], fh.expo.tobytes())
    put(offs[8], fh.lens.tobytes())
    put(offs[9], fh.wbal.tobytes())
    return buf


def _buf(b):
    return (ctypes.c_char * len(b)).from_buffer(b)


def dng_header(fh, fps: float = 0.0, basename: str = "") -> bytes:
    b = pack_frame_headers(fh)
    out = bytearray(65536)
    n = lib().oracle_dng_header(
        _buf(b), _buf(out), ctypes.c_size_t(65536), ctypes.c_double(fps), basename.encode()
    )
    return bytes(out[:n])


def unpack(fh, packed_words: np.ndarray, num_pixels: int) -> np.ndarray:
    b = pack_frame_headers(fh)
    packed = np.ascontiguousarray(packed_words, "<u2")
    out = np.zeros(num_pixels, "<u2")
    lib().oracle_unpack(
        _buf(b),
        packed.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(num_pixels * 2),
    )
    return out


def chroma_smooth(fh, img: np.ndarray, method: int) -> np.ndarray:
    b = pack_frame_headers(fh)
    data = np.ascontiguousarray(img, "<u2").copy()
    lib().oracle_chroma_smooth(_buf(b), data.ctypes.data_as(ctypes.c_void_p), method)
    return data


def fix_focus_pixels(fh, img: np.ndarray, dual_iso: int, cwd: str = None) -> np.ndarray:
    """Note: the reference loads .fpm maps from the process CWD (cs.c:369)."""
    b = pack_frame_headers(fh)
    data = np.ascontiguousarray(img, "<u2").copy()
    old = os.getcwd()
    if cwd:
        os.chdir(cwd)
    try:
        lib().oracle_fix_focus_pixels(_buf(b), data.ctypes.data_as(ctypes.c_void_p), dual_iso)
    finally:
        if cwd:
            os.chdir(old)
    return data


def fix_bad_pixels(fh, img: np.ndarray, aggressive: int, dual_iso: int) -> np.ndarray:
    b = pack_frame_headers(fh)
    data = np.ascontiguousarray(img, "<u2").copy()
    lib().oracle_fix_bad_pixels(
        _buf(b), data.ctypes.data_as(ctypes.c_void_p), aggressive, dual_iso
    )
    return data


def fix_pattern_noise(img: np.ndarray, white: int) -> np.ndarray:
    data = np.ascontiguousarray(img, "<i2").copy()
    h, w = data.shape
    lib().oracle_fix_pattern_noise(data.ctypes.data_as(ctypes.c_void_p), w, h, white, 0)
    return data


def stripes(fh, img: np.ndarray, apply: bool = True):
    b = pack_frame_headers(fh)
    data = np.ascontiguousarray(img, "<u2").copy()
    gains = (ctypes.c_int * 8)()
    needed = lib().oracle_stripes(
        _buf(b),
        data.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(data.size),
        gains,
        1 if apply else 0,
    )
    return data, np.array(gains[:8]), bool(needed)


def hdr_preview(fh, img: np.ndarray, cwd: str = None):
    """``cwd``: directory holding .fpm maps — the preview path fixes focus
    pixels itself on detected frames (hdr.c:109), loading maps from the
    process CWD (cs.c:369)."""
    b = pack_frame_headers(fh)
    data = np.ascontiguousarray(img, "<u2").copy()
    old = os.getcwd()
    if cwd:
        os.chdir(cwd)
    try:
        ok = lib().oracle_hdr_preview(
            _buf(b), data.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(data.size * 2)
        )
    finally:
        if cwd:
            os.chdir(old)
    black = ctypes.c_int()
    white = ctypes.c_int()
    lib().oracle_get_levels(_buf(b), ctypes.byref(black), ctypes.byref(white))
    return data, bool(ok), black.value, white.value


def cr2hdr20(fh, img: np.ndarray, interp=0, fullres=1, alias_map=1, cs_method=0, bad_pix=0):
    b = pack_frame_headers(fh)
    data = np.ascontiguousarray(img, "<u2").copy()
    ok = lib().oracle_cr2hdr20(
        _buf(b), data.ctypes.data_as(ctypes.c_void_p), interp, fullres, alias_map, cs_method, bad_pix
    )
    black = ctypes.c_int()
    white = ctypes.c_int()
    lib().oracle_get_levels(_buf(b), ctypes.byref(black), ctypes.byref(white))
    return data, bool(ok), black.value, white.value


def process_frame(
    fh,
    img: np.ndarray,
    deflicker: int = 0,
    fps: float = 0.0,
    basename: str = "",
    pattern: int = 0,
    dual_iso: int = 0,
    interp: int = 0,
    fullres: int = 1,
    alias_map: int = 1,
    chroma: int = 0,
    bad_pix: int = 0,
    stripes: int = 0,
    cwd: str = None,
):
    """The composed reference process_frame chain (main.c:908-1005).

    Returns (data, header, is_dual, gains, stripes_needed). ``cwd`` is the
    .fpm map directory (the chain's fix_focus_pixels loads from CWD).
    """
    b = pack_frame_headers(fh)
    data = np.ascontiguousarray(img, "<u2").copy()
    header = bytearray(65536)
    gains = (ctypes.c_int * 8)()
    needed = ctypes.c_int(0)
    old = os.getcwd()
    if cwd:
        os.chdir(cwd)
    try:
        is_dual = lib().oracle_process_frame(
            _buf(b),
            data.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(data.size * 2),
            _buf(header),
            ctypes.c_size_t(65536),
            deflicker,
            ctypes.c_double(fps),
            basename.encode(),
            pattern,
            dual_iso,
            interp,
            fullres,
            alias_map,
            chroma,
            bad_pix,
            stripes,
            gains,
            ctypes.byref(needed),
        )
    finally:
        if cwd:
            os.chdir(old)
    return data, bytes(header), bool(is_dual), np.array(gains[:8]), bool(needed.value)


def deflicker(fh, target: int, img: np.ndarray):
    b = pack_frame_headers(fh)
    data = np.ascontiguousarray(img, "<u2")
    bias = (ctypes.c_int32 * 2)()
    lib().oracle_deflicker(
        _buf(b), target, data.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(data.size * 2), bias
    )
    return int(bias[0]), int(bias[1])


class capture_c_stdout:
    """Capture printf output from oracle calls (the reference logs its
    dual-ISO analysis — ISO pattern, white levels, fitted EV — to stdout)."""

    def __enter__(self):
        import tempfile

        self._tmp = tempfile.TemporaryFile()
        self._saved = os.dup(1)
        import sys

        sys.stdout.flush()
        os.dup2(self._tmp.fileno(), 1)
        return self

    def __exit__(self, *exc):
        import sys

        try:
            lib()  # ensure libc buffers flushed via fflush(NULL)
            import ctypes

            ctypes.CDLL(None).fflush(None)
        except Exception:
            pass
        sys.stdout.flush()
        os.dup2(self._saved, 1)
        os.close(self._saved)
        self._tmp.seek(0)
        self.text = self._tmp.read().decode("utf-8", "replace")
        self._tmp.close()
        return False


def amaze(raw01: np.ndarray):
    """Run the reference AMaZE demosaic on a [0,1]-scaled mosaic*65535.

    Input convention matches amaze_interpolate (hdr.c:962-1040): float32
    buffer of pixel values (0..65535 scale), rows padded to width+16.
    Returns (red, green, blue) float32 planes.
    """
    h, w = raw01.shape
    stride = w + 16
    rawp = np.zeros((h, stride), np.float32)
    rawp[:, :w] = raw01
    r = np.zeros((h, stride), np.float32)
    g = np.zeros((h, stride), np.float32)
    b = np.zeros((h, stride), np.float32)
    L = lib()
    L.oracle_amaze(
        rawp.ctypes.data_as(ctypes.c_void_p),
        r.ctypes.data_as(ctypes.c_void_p),
        g.ctypes.data_as(ctypes.c_void_p),
        b.ctypes.data_as(ctypes.c_void_p),
        w, h, stride,
    )
    return r[:, :w], g[:, :w], b[:, :w]


def lj92_decode(data: bytes, max_pixels: int = 1 << 26):
    """Reference LJ92 decoder (lj92_open/lj92_decode)."""
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(max_pixels, np.uint16)
    dims = (ctypes.c_int * 3)()
    rc = lib().oracle_lj92_decode(
        buf.ctypes.data_as(ctypes.c_void_p), len(buf),
        out.ctypes.data_as(ctypes.c_void_p), max_pixels, dims,
    )
    if rc != 0:
        raise ValueError(f"reference lj92 decode failed ({rc})")
    w, h, bits = dims[0], dims[1], dims[2]
    return out[: w * h].reshape(h, w).copy(), w, h, bits


def lj92_encode(img: np.ndarray, bitdepth: int = 16) -> bytes:
    """Reference LJ92 encoder (lj92_encode, shipped-but-unused in MLVFS)."""
    img = np.ascontiguousarray(img, np.uint16)
    h, w = img.shape
    cap = img.nbytes * 3 + 4096
    out = np.empty(cap, np.uint8)
    n = lib().oracle_lj92_encode(
        img.ctypes.data_as(ctypes.c_void_p), w, h, bitdepth,
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if n < 0:
        raise ValueError(f"reference lj92 encode failed ({n})")
    return out[:n].tobytes()


def has_audio(path: str) -> bool:
    return bool(lib().oracle_has_audio(path.encode()))


def wav_size(path: str) -> int:
    L = lib()
    L.oracle_wav_size.restype = ctypes.c_long
    return int(L.oracle_wav_size(path.encode()))


def wav(path: str, seed: int = 1) -> bytes:
    """Whole reference WAV file. ``seed`` feeds srand() before the single
    rand() call that stamps bext originator_reference (wav.c:253)."""
    L = lib()
    L.oracle_wav.restype = ctypes.c_long
    size = wav_size(path)
    out = bytearray(size)
    n = int(L.oracle_wav(path.encode(), _buf(out), ctypes.c_size_t(size),
                         ctypes.c_uint(seed)))
    return bytes(out[:n])


def rand_after_seed(seed: int = 1) -> int:
    """glibc rand() value the oracle's srand(seed) produces — the value the
    writer here must stamp to match byte-for-byte."""
    libc = ctypes.CDLL("libc.so.6")
    libc.srand(ctypes.c_uint(seed))
    return int(libc.rand())


def gif_size(fh) -> int:
    L = lib()
    L.oracle_gif_size.restype = ctypes.c_long
    b = pack_frame_headers(fh)
    return int(L.oracle_gif_size(_buf(b)))


def gif(path: str, fh) -> bytes:
    """Whole reference preview GIF (10 decoded frames, uncompressed clips)."""
    L = lib()
    L.oracle_gif.restype = ctypes.c_long
    size = gif_size(fh)
    out = bytearray(size)
    n = int(L.oracle_gif(path.encode(), _buf(out), ctypes.c_size_t(size)))
    return bytes(out[:n])
