"""Batch MLV → DNG conversion engine.

This is the accelerator-side replacement for the reference's FUSE read path
(mlvfs_read → get_or_create_image_buffer → process_frame, main.c:1410-1576,
908-1005): instead of decoding one frame per filesystem read under a cache
mutex, we stream batches of packed frames to the device, run the whole
processing pipeline as one jitted program per batch, and write DNGs out.

Pipeline stages (overlapped via the prefetch ring in ``stream.py``):
  host: index + gather packed payload slices (zero-copy from memmap)
  device: unpack → fixups → dual-ISO → stencil corrections  (one XLA program)
  host: 64 KiB CDNG header synthesis + file write
"""

from __future__ import annotations

import concurrent.futures as _futures
import functools
import lzma
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..format.reader import MLVClip
from ..ops import unpack as unpack_ops
from .config import ProcessingConfig
from ..emit import dng as dng_emit


@functools.lru_cache(maxsize=32)
def _unpack_jit_for(bpp: int, h: int, w: int):
    """Module-level jitted unpack, keyed by geometry: converters for clips
    of the same shape share one compiled program instead of re-tracing a
    fresh per-instance closure (directory conversions touch many clips)."""

    @jax.jit
    def run(words):
        return unpack_ops.unpack_batch(words, bpp, h, w)

    return run


@jax.jit
def _detile_jit_shared(samples):
    return jax.vmap(unpack_ops.lj92_detile)(samples)


def _mlv_basename(path: str) -> str:
    base = os.path.basename(path)
    return base[:-4] if base.upper().endswith(".MLV") else base


def dng_frame_name(basename: str, frame: int, camera_model=0, name_scheme: int = 0) -> str:
    """Virtual DNG naming (main.c:1308 '%s_%06d.dng')."""
    return f"{basename}_{frame:06d}.dng"


def resolve_basename(path: str, fh) -> str:
    """DaVinci Resolve naming scheme (get_mlv_basename, main.c:724-728):
    <name><EXT>_1_YYYY-MM-DD_0001_C0000 derived from the RTCI date."""
    base, ext = os.path.splitext(os.path.basename(path))
    rtci = fh.rtci
    return "%s%s_1_%d-%02d-%02d_%04d_C%04d" % (
        base,
        ext[1:],
        1900 + int(rtci["tm_year"]),
        int(rtci["tm_mon"]) + 1,
        int(rtci["tm_mday"]),
        1,
        0,
    )


class ClipConverter:
    """Converts one clip; owns the per-clip calibration state.

    Per-clip state mirrors the reference's caches: stripe correction from the
    first frame (main.c:980-996), bad-pixel map per file GUID (cs.c:233-312).
    """

    def __init__(self, clip: MLVClip, config: ProcessingConfig = None):
        from ..utils.cache import enable_compile_cache

        enable_compile_cache()
        self.clip = clip
        self.config = config or ProcessingConfig()
        self.fh0 = clip.frame_headers(0) if clip.frame_count else None
        self._write_pool = _futures.ThreadPoolExecutor(max_workers=4)
        ncpu = os.cpu_count() or 1
        self._decode_pool = (
            _futures.ThreadPoolExecutor(max_workers=min(8, ncpu)) if ncpu > 1 else None
        )
        self._calibration = None
        self._templates = {}
        self._buf_ring = {}
        self._buf_turn = 0
        self._buf_lock = threading.Lock()
        self._sharding = None
        self._batch_target = self.config.batch_size
        n_dev = int(getattr(self.config, "shard_devices", 0) or 0)
        if n_dev > len(jax.devices()):
            raise ValueError(
                f"--devices {n_dev} asks for more devices than the "
                f"{len(jax.devices())} this process sees"
            )
        if n_dev > 1:
            from ..parallel.mesh import make_mesh, frames_sharding, batch_target

            self._mesh = make_mesh(n_dev)
            self._sharding = frames_sharding(self._mesh)
            self._batch_target = batch_target(self.config.batch_size, self._mesh)

    # ------------------------------------------------------------------ #

    def _decode_batch_host(self, indices):
        """Host-side decode for LJ92 clips → (B, H, W) uint16 tiled samples
        (the 2D de-tiling runs on the device, fused into the batch program).

        One native call decodes the whole batch, fanned over hardware
        threads (lj92_decode_batch_buf) — the reference gets its decode
        parallelism from the FUSE thread pool. Codec failures are isolated
        per frame like the reference (get_image_data logs 'LJ92: Failed'
        and leaves the frame blank, main.c:598-681).
        """
        from ..codecs import lj92 as lj92_codec
        from ..utils import log

        fh = self.fh0
        h, w = fh.yres, fh.xres
        streams = [np.asarray(self.clip.frame_payload(i))[4:].tobytes() for i in indices]
        out, rcs = lj92_codec.decode_batch(streams, h * w)
        for bi, rc in enumerate(rcs):
            if rc != 0:  # corrupt stream: frame stays blank, keep going
                log.error("lj92 decode failed for frame %d (rc=%d)", indices[bi], rc)
        return out.reshape(len(indices), h, w)

    def _lzma_batch_host(self, indices):
        """Host LZMA decompress → packed word streams (B, n_words).

        The reference passes LzmaUncompress output straight to
        dng_get_image_data (main.c:605-611): the decompressed bytes are the
        *packed* bpp bitstream, which then takes the same device bit-unpack
        as uncompressed clips.
        """
        from ..utils import log

        fh = self.fh0
        n_words = unpack_ops.words_for_pixels(
            fh.yres * fh.xres, fh.raw_info.bits_per_pixel
        )
        out = np.zeros((len(indices), n_words), "<u2")

        def decode_one(bi, i):
            payload = np.asarray(self.clip.frame_payload(i))
            try:
                out_size = int(payload[:4].view("<u4")[0])
                props = payload[4:9].tobytes()
                body = payload[9:].tobytes()
                dec = lzma.LZMADecompressor(
                    format=lzma.FORMAT_ALONE,
                    # FORMAT_ALONE header: props + uncompressed size (-1 = unknown)
                )
                packed = dec.decompress(props + b"\xff" * 8 + body, max_length=out_size)
                words = np.frombuffer(packed, "<u2", len(packed) // 2)
                out[bi, : min(n_words, len(words))] = words[:n_words]
            except Exception as e:  # corrupt stream: drop the frame, keep going
                log.error("lzma decode failed for frame %d: %s", i, e)

        # liblzma releases the GIL: decode the batch across cores
        pool = self._decode_pool
        if pool is None or len(indices) == 1:
            for bi, i in enumerate(indices):
                decode_one(bi, i)
        else:
            list(pool.map(lambda a: decode_one(*a), list(enumerate(indices))))
        return out

    def _gather_packed_views(self, indices):
        """Per-frame packed word views straight off the chunk memmaps.

        Zero-copy host side of the uncompressed read path: each frame's
        packed payload is contiguous inside its mapped chunk, so the device
        transfer (jax.device_put per frame, stacked on device) reads the
        page cache directly — the host CPU never copies the payload. This
        replaced the staged batch copy, the single biggest host-leg cost at
        1080p (~0.67 ms/frame of a ~2.1 ms budget on a 1-CPU rig; the
        reference instead pays a per-pixel unpack copy on every FUSE read,
        main.c:1410-1576). Short/odd-sized payloads (corrupt tail) fall
        back to a padded per-frame copy.
        """
        fh = self.fh0
        n_words = unpack_ops.words_for_pixels(fh.yres * fh.xres, fh.raw_info.bits_per_pixel)
        views = []
        for i in indices:
            payload = np.asarray(self.clip.frame_payload(i))
            words = unpack_ops.bytes_to_words_np(payload)
            if words.shape[0] >= n_words:
                views.append(words[:n_words])
            else:  # short/corrupt frame: blank the tail
                buf = np.zeros(n_words, "<u2")
                buf[: words.shape[0]] = words
                views.append(buf)
        return views

    def _put_views(self, views):
        """Device-stack per-frame views (see _gather_packed_views): pad the
        batch to the fixed target by repeating the last frame, transfer each
        view (async; the transfer engine reads the mapped pages), and stack
        on device so every batch lands on the same compiled program.

        Trade (vs the staged single transfer kept for the sharded and
        compressed paths, _put): B transfer submissions + one on-device
        stack instead of one submission preceded by a ~0.6 ms/frame host
        payload copy. The extra work is one device-to-device batch copy
        (~116 MB at 1080p/B=16) plus a transient 2x footprint, and B-1 extra
        transfer submissions. The staged path (_put) is kept for the
        compressed clips."""
        if len(views) < self._batch_target:
            views = list(views) + [views[-1]] * (self._batch_target - len(views))
        return jnp.stack([jax.device_put(v) for v in views])

    def _put_views_sharded(self, views):
        """Zero-copy gather for the sharded path (--devices>1).

        jax.make_array_from_single_device_arrays assembles a global sharded
        array from one committed array per device; each device's shard is
        the on-device stack of its frames' memmap views, transferred
        view-by-view (the transfer engine reads the page cache directly).
        This removes the staged host batch copy the sharded path re-paid
        after r4 made the unsharded path zero-copy (the ~0.6 ms/frame
        _gather_packed_batch cost; the reference instead pays a per-pixel
        unpack copy on every FUSE read, main.c:1410-1576). Shard slices come
        from the sharding's own device→index map, so the frame→device
        placement is exactly what jax.device_put(batch, sharding) would
        produce — sharded output stays bit-identical to the staged path
        (tests/test_stream_shard.py gates this on the 8-device CPU mesh)."""
        if len(views) < self._batch_target:
            views = list(views) + [views[-1]] * (self._batch_target - len(views))
        global_shape = (len(views),) + views[0].shape
        idx_map = self._sharding.addressable_devices_indices_map(global_shape)
        shards = []
        for dev, idx in idx_map.items():
            chunk = views[idx[0]]  # idx[0] is the batch-dim slice
            shards.append(jnp.stack([jax.device_put(v, dev) for v in chunk]))
        return jax.make_array_from_single_device_arrays(
            global_shape, self._sharding, shards
        )

    def _gather_packed_batch(self, indices):
        """Stack packed word streams for a batch of frames (uncompressed clips).

        Buffers come from a small reuse ring: a fresh allocation per batch
        costs the kernel a zero-fill of ~85 MB of new anonymous pages at
        1080p (even np.empty pages are zeroed on first touch) — reusing warm
        pages leaves only the payload copy. The ring is deep enough that a
        buffer is never rewritten while a previous batch's device transfer
        may still be reading it (prefetch depth + 1)."""
        fh = self.fh0
        n_words = unpack_ops.words_for_pixels(fh.yres * fh.xres, fh.raw_info.bits_per_pixel)
        out = self._gather_buffer((len(indices), n_words))
        for bi, i in enumerate(indices):
            payload = np.asarray(self.clip.frame_payload(i))
            words = unpack_ops.bytes_to_words_np(payload)
            n = min(n_words, len(words))
            out[bi, :n] = words[:n]
            if n < n_words:  # short/corrupt frame: blank the tail
                out[bi, n:] = 0
        return out

    def _gather_buffer(self, shape) -> np.ndarray:
        """Warm staging buffer from a small ring (see _gather_packed_batch).

        Lock-protected turn: up to ``prefetch`` fetches run concurrently on
        the BatchPrefetcher's pool, and an unguarded read-modify-write of the
        turn could hand the same buffer to two in-flight batches. The ring is
        one deeper than the prefetch depth, so concurrent fetches always get
        distinct buffers and the previous batch's buffer survives until its
        device transfer has drained."""
        depth = max(2, int(self.config.prefetch) + 1)
        with self._buf_lock:
            self._buf_turn = (self._buf_turn + 1) % depth
            key = (shape, self._buf_turn)
            buf = self._buf_ring.get(key)
            if buf is None:
                buf = self._buf_ring[key] = np.empty(shape, "<u2")
        return buf

    # ------------------------------------------------------------------ #

    @property
    def _unpack_jit(self):
        fh = self.fh0
        return _unpack_jit_for(fh.raw_info.bits_per_pixel, fh.yres, fh.xres)

    @property
    def _detile_jit(self):
        return _detile_jit_shared

    def _put(self, host_array):
        """Pad to the fixed batch shape and stage on the device(s).

        Every batch of a clip lands on the same compiled program: tail
        batches are padded up to the target (a mesh multiple when sharding)
        by repeating their last frame, rather than compiling a second
        unsharded layout for the remainder."""
        from ..parallel.mesh import pad_frames

        host_array = pad_frames(host_array, self._batch_target)
        if self._sharding is not None:
            return jax.device_put(host_array, self._sharding)
        return jnp.asarray(host_array)

    def fetch_batch(self, indices):
        """Host side of decode: gather/decode + async device transfer.
        Runs on the prefetch thread (stream.BatchPrefetcher)."""
        comp = self.fh0.compression
        if comp == "none":
            views = self._gather_packed_views(indices)
            if self._sharding is None:
                return self._put_views(views)
            return self._put_views_sharded(views)
        if comp == "lzma":
            return self._put(self._lzma_batch_host(indices))
        if comp == "lj92":
            return self._put(self._decode_batch_host(indices))
        raise ValueError(f"unknown compression {comp}")

    def decode_batch(self, indices, fetched=None) -> jnp.ndarray:
        """Decode frames → device array (B, H, W) uint16 (pre-processing)."""
        if fetched is None:
            fetched = self.fetch_batch(indices)
        if self.fh0.compression in ("none", "lzma"):
            # both carry the packed bpp bitstream → device bit-unpack
            return self._unpack_jit(fetched)
        # lj92: host entropy decode produced tiled samples; de-tile on device
        return self._detile_jit(fetched)

    def process_batch(self, imgs: jnp.ndarray, indices):
        """Run the configured processing pipeline on a decoded batch.

        Returns (imgs_u16, per_frame_info) where per_frame_info carries
        header mutations (deflicker exposure bias, dual-ISO level scaling).
        """
        cfg = self.config
        fh = self.fh0
        ri = fh.raw_info
        info = {
            "black_level": ri.black_level,
            "white_level": ri.white_level,
            "exposure_bias": None,
        }

        from . import kernels

        imgs, info = kernels.run_pipeline(imgs, fh, cfg, self._get_calibration(), info)
        return imgs, info

    def _get_calibration(self):
        """Per-clip calibration state (focus map; lazy stripe/bad-pixel cal).

        Restored from the `.CAL` sidecar when present (SURVEY.md section 5:
        checkpoint/resume extends the .IDX idea to per-clip calibration)."""
        if self._calibration is None:
            from . import kernels, calibration

            self._calibration = kernels.calibrate_clip(self.fh0, self.config)
            if self.config.use_sidecar_idx:
                calibration.load_into(
                    self._calibration, self.clip.path, self.clip.guid, self.config
                )
        return self._calibration

    # ------------------------------------------------------------------ #

    def convert(self, outdir: str, frames=None, progress=None):
        """Convert frames to DNG files in ``outdir``. Returns written paths."""
        os.makedirs(outdir, exist_ok=True)
        clip = self.clip
        cfg = self.config
        if clip.frame_count == 0:
            # no video frames: still export the virtual-directory sidecars
            # (the reference lists .wav/.log/_PREVIEW.gif regardless of the
            # VIDF count, main.c:1306-1320)
            if cfg.export_all:
                return sorted(self.write_sidecars(outdir, _mlv_basename(clip.path)))
            return []
        if cfg.name_scheme == 1:
            basename = resolve_basename(clip.path, self.fh0)
        else:
            basename = _mlv_basename(clip.path)
        frames = list(range(clip.frame_count)) if frames is None else list(frames)
        paths = []
        pending = []
        from ..utils import StageTimer, metrics
        from .stream import BatchPrefetcher

        if cfg.resume:
            # restartable conversion: skip frames whose DNG is already on disk
            todo = []
            for i in frames:
                path = os.path.join(outdir, dng_frame_name(basename, i, name_scheme=cfg.name_scheme))
                if os.path.isfile(path) and os.path.getsize(path) > dng_emit.HEADER_SIZE:
                    paths.append(path)
                else:
                    todo.append(i)
            metrics.count("frames_resumed", len(frames) - len(todo))
            frames = todo

        batches = [frames[i : i + cfg.batch_size] for i in range(0, len(frames), cfg.batch_size)]
        prefetcher = BatchPrefetcher(self.fetch_batch, batches, depth=max(1, cfg.prefetch))
        done = 0
        for indices, fetched in prefetcher:
            with StageTimer("decode"):
                imgs = self.decode_batch(indices, fetched)
            with StageTimer("process"):
                imgs, info = self.process_batch(imgs, indices)
            # readback + header synthesis + file IO run on the write pool so
            # the device->host transfer of batch N overlaps batch N+1's
            # decode/process (the transfer is the main per-batch sync point)
            pending.append(
                self._write_pool.submit(
                    self._finish_batch, outdir, basename, indices, imgs, info
                )
            )
            for i in indices:
                paths.append(
                    os.path.join(outdir, dng_frame_name(basename, i, name_scheme=cfg.name_scheme))
                )
            done += len(indices)
            if progress:
                progress(done, len(frames))
        for fut in pending:
            fut.result()
        if self._calibration is not None and cfg.use_sidecar_idx:
            from . import calibration

            calibration.save_from(self._calibration, clip.path, clip.guid, cfg)
        if cfg.export_all:
            paths.extend(self.write_sidecars(outdir, basename))
        return sorted(paths)

    def write_sidecars(self, outdir: str, basename: str):
        """Write the clip's non-DNG virtual-directory entries next to the DNGs.

        One-invocation export parity with the reference's virtual clip
        directory (main.c:1308-1320): <base>.wav when the clip has audio,
        <base>.log (camera debug log, may be empty), <base>_PREVIEW.gif.
        """
        from ..emit.gif import build_gif, gif_frame_ids
        from ..emit.wav import build_wav

        clip = self.clip
        written = []
        if clip.has_audio:
            p = os.path.join(outdir, basename + ".wav")
            with open(p, "wb") as f:
                f.write(build_wav(clip))
            written.append(p)
        p = os.path.join(outdir, basename + ".log")
        with open(p, "w") as f:
            f.write(clip.debug_log())
        written.append(p)
        if clip.frame_count:
            frame_ids = gif_frame_ids(clip.frame_count)
            batch = np.asarray(jax.device_get(self.decode_batch(frame_ids)))
            decoded = {i: batch[bi] for bi, i in enumerate(frame_ids)}
            gif_bytes = build_gif(clip, decode_fn=decoded.__getitem__)
        else:
            gif_bytes = build_gif(clip)  # empty, like the reference's read
        p = os.path.join(outdir, basename + "_PREVIEW.gif")
        with open(p, "wb") as f:
            f.write(gif_bytes)
        written.append(p)
        return written

    def _finish_batch(self, outdir, basename, indices, imgs, info):
        """Write-pool task: pull the batch to host and write its DNGs.

        Header synthesis goes through a per-clip template (one full build per
        metadata epoch, cheap renders after that). See DNGHeaderTemplate."""
        from ..utils import StageTimer, metrics

        cfg = self.config
        with StageTimer("readback"):
            imgs_np = np.asarray(jax.device_get(imgs), "<u2")
        metrics.count("frames", len(indices))
        metrics.count("bytes_out", int(imgs_np.nbytes))
        strips = None
        if cfg.compress == "lj92":
            # one native call per batch, frames fanned over hardware threads
            # (byte-identical to per-frame encode; see lj92_encode_batch_buf)
            from ..codecs import lj92 as lj92_codec

            with StageTimer("lj92_encode"):
                strips = lj92_codec.encode_batch(
                    imgs_np[: len(indices)], ncomp=2, bits=16
                )
        compression = "lj92" if strips is not None else "none"
        tpl = None
        tpl_ident = None
        for bi, i in enumerate(indices):
            # shared-snapshot headers: render() only reads them, and the
            # per-frame full copies were ~90 us/frame of the write path
            fh = self.clip.frame_headers_shared(i)
            # template reuse by block identity: frame_headers_shared hands out
            # the SAME metadata objects while the clip's snapshot is unchanged,
            # so an `is`-check replaces the 4x tobytes() key per frame
            ident = (id(fh.expo), id(fh.lens), id(fh.wbal), id(fh.rtci))
            if ident != tpl_ident:
                tpl = self._header_template(fh, basename, compression=compression)
                tpl_ident = ident
            black, white, bias = self._info_fields(info, bi)
            path = os.path.join(outdir, dng_frame_name(basename, i, name_scheme=cfg.name_scheme))
            if strips is not None:
                header = tpl.render(
                    fh, black_level=black, white_level=white, exposure_bias=bias,
                    strip_byte_count=len(strips[bi]),
                )
                self._write_dng(path, header, np.frombuffer(strips[bi], np.uint8))
            else:
                header = tpl.render(
                    fh, black_level=black, white_level=white, exposure_bias=bias
                )
                self._write_dng(path, header, imgs_np[bi])

    def _info_fields(self, info, bi):
        """Per-frame header mutations from the processed-batch info dict."""
        levels = info.get("levels")
        if levels is not None:
            black, white = int(levels[bi][0]), int(levels[bi][1])
        else:
            black, white = info.get("black_level"), info.get("white_level")
        eb = info.get("exposure_bias")
        bias = (int(eb[bi][0]), int(eb[bi][1])) if eb is not None else None
        return black, white, bias

    def _header_template(self, fh, basename, compression="none"):
        """Template cache keyed on the metadata blocks that feed the header
        (EXPO/LENS/WBAL/RTCI can change mid-clip; MLVI/RAWI/IDNT are static)."""
        key = (
            compression,
            fh.expo.tobytes(),
            fh.lens.tobytes(),
            fh.wbal.tobytes(),
            fh.rtci.tobytes(),
        )
        tpl = self._templates.get(key)
        if tpl is None:
            tpl = dng_emit.DNGHeaderTemplate(
                fh, self.config.fps, basename, compression=compression,
                strip_byte_count=0 if compression == "lj92" else None,
            )
            self._templates[key] = tpl
        return tpl

    @staticmethod
    def _write_dng(path: str, header: bytes, img: np.ndarray):
        # one writev syscall, no stdio buffer and no tobytes() copy of the
        # 2·W·H image payload; the tmpfs page-allocating copy (~1.2 ms at
        # 1080p) is the kernel floor for the per-frame write
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.writev(fd, [header, memoryview(img).cast("B")])
        finally:
            os.close(fd)
        os.replace(tmp, path)

    def _apply_info(self, fh, info, bi):
        """Apply per-batch header mutations before building the DNG header."""
        ri = fh.rawi["raw_info"]
        levels = info.get("levels")
        if levels is not None:
            ri["black_level"], ri["white_level"] = levels[bi]
        elif info.get("black_level") is not None:
            ri["black_level"] = info["black_level"]
            ri["white_level"] = info["white_level"]
        eb = info.get("exposure_bias")
        if eb is not None:
            ri["exposure_bias"] = (int(eb[bi][0]), int(eb[bi][1]))

    def close(self):
        self._write_pool.shutdown(wait=True)
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=True)


def convert_clip(mlv_path: str, outdir: str, config: ProcessingConfig = None, **kw):
    """One-shot conversion of a single clip."""
    # populate=True: a full conversion reads every frame, so prefault the
    # chunk mappings in one kernel pass (MAP_POPULATE) instead of a minor
    # fault per page inside the gather copies
    with MLVClip(
        mlv_path,
        use_sidecar=(config or ProcessingConfig()).use_sidecar_idx,
        populate=True,
    ) as clip:
        conv = ClipConverter(clip, config)
        try:
            return conv.convert(outdir, **kw)
        finally:
            conv.close()
