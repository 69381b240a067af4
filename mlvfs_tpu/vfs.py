"""Virtual filesystem view of an MLV directory.

The reference presents each .MLV as a virtual directory of CinemaDNG frames
plus .wav/.log/_PREVIEW.gif through FUSE (main.c:1084-1823). This module is
that presentation layer as a library: a `VirtualFS` maps virtual paths to
listings, attributes, and offset-addressable file contents, backed by the
batch conversion engine. The web dashboard (`server.py`) and any mount
adapter sit on top of it.

Components mirrored:
  - path resolution and naming schemes incl. DaVinci Resolve names
    (mlvfs_resolve_path main.c:800-872, get_mlv_basename main.c:715-735,
    get_mlv_name_from_basename main.c:752-778)
  - directory listing semantics (mlvfs_readdir main.c:1272-1405), including
    .MLD sidecar passthrough
  - the decoded-frame cache with the reference's bounds: at most 4 unused
    and 16 total buffers in memory (resource_manager.c:39-40)
"""

from __future__ import annotations

import os
import re
import threading

import numpy as np

from .format.reader import MLVClip, is_mlv_name
from .pipeline.config import ProcessingConfig
from .emit import dng as dng_emit
from .emit.wav import build_wav, wav_size
from .emit.gif import build_gif, gif_size

_RESOLVE_RE = re.compile(r"(.+)(MLV|mlv)_1_\d+-\d+-\d+_\d+_[Cc]\d+")


class ResourceManager:
    """Keyed cache of built byte buffers with the reference's eviction bounds
    (get_or_create_image_buffer / image_buffer_cleanup,
    resource_manager.c:92-227): <= 4 unused buffers, <= 16 total.

    The bounds are constructor-tunable: the mount's batch readahead primes a
    window of frames ahead of the reader, which needs room for ~2 batches
    (the reference's 4/16 fit its one-frame-per-FUSE-read demand paging)."""

    MAX_UNUSED = 4
    MAX_TOTAL = 16

    def __init__(self, max_unused: int = None, max_total: int = None):
        self._lock = threading.Lock()
        self._entries = {}  # key -> dict(value, refs, lock)
        self._order = []
        if max_unused is not None:
            self.MAX_UNUSED = max_unused
        if max_total is not None:
            self.MAX_TOTAL = max_total

    def put(self, key, value):
        """Insert a prebuilt buffer (refs=0) — readahead priming."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = {"value": value, "refs": 0, "lock": threading.Lock()}
                self._entries[key] = e
                self._order.append(key)
            elif e["value"] is None:
                e["value"] = value
            self._evict()

    def contains(self, key) -> bool:
        with self._lock:
            e = self._entries.get(key)
            return e is not None and e["value"] is not None

    def get_or_create(self, key, builder):
        """Build-or-get AND pin (+1 ref). Pair with release(); use fetch()
        for unpinned access (per-chunk reads, one-shot server reads)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = {"value": None, "refs": 0, "lock": threading.Lock()}
                self._entries[key] = e
                self._order.append(key)
            e["refs"] += 1
        with e["lock"]:
            if e["value"] is None:
                e["value"] = builder()
        return e["value"]

    def fetch(self, key, builder):
        """Build-or-get without pinning (refs unchanged)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = {"value": None, "refs": 0, "lock": threading.Lock()}
                self._entries[key] = e
                self._order.append(key)
        with e["lock"]:
            if e["value"] is None:
                e["value"] = builder()
        return e["value"]

    def peek(self, key):
        """Cached value or None; never builds, never pins."""
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else e["value"]

    def release(self, key):
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            e["refs"] = max(0, e["refs"] - 1)
            self._evict()

    def _evict(self):
        unused = [k for k in self._order if self._entries[k]["refs"] == 0]
        # oldest-first eviction beyond the bounds
        while len(unused) > self.MAX_UNUSED or len(self._order) > self.MAX_TOTAL:
            victim = None
            for k in self._order:
                if self._entries[k]["refs"] == 0:
                    victim = k
                    break
            if victim is None:
                break
            self._order.remove(victim)
            del self._entries[victim]
            unused.remove(victim)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._order.clear()


class VirtualFS:
    def __init__(self, mlv_dir: str, config: ProcessingConfig = None,
                 readahead: int = None):
        """``readahead``: frames decoded per cold DNG read (batched through
        the conversion engine) and primed into the buffer cache, plus one
        batch of background prefetch — sequential mount reads then ride the
        batch engine instead of demand-paging one frame per FUSE round trip
        (the reference gets concurrency from the FUSE thread pool instead,
        README.md:22-24). 1 disables (pure demand paging)."""
        self.mlv_dir = os.path.abspath(mlv_dir)
        self.config = config or ProcessingConfig(batch_size=1)
        if readahead is None:
            readahead = max(1, self.config.batch_size)
        self.readahead = max(1, int(readahead))
        self.buffers = ResourceManager(
            max_unused=max(ResourceManager.MAX_UNUSED, 2 * self.readahead),
            max_total=max(ResourceManager.MAX_TOTAL, 3 * self.readahead),
        )
        self._clips = {}
        self._converters = {}
        self._lock = threading.RLock()
        self._ra_pool = None
        self._ra_futures = {}  # (mlv_path, batch_start) -> Future
        self._build_lock = threading.Lock()
        self._path_cache = {}  # vpath -> buffer key (fast per-chunk reads)
        self._attr_cache = {}  # mlv_path -> virtual file sizes
        # observability: device-build counters, readable through the mount at
        # /.mlvfs-stats (hidden from listings) so tests and users can verify
        # sequential reads ride the batch engine rather than demand paging
        self.stats = {"builds": 0, "frames_built": 0}

    # -- naming -------------------------------------------------------------

    def virtual_dir_name(self, mlv_filename: str) -> str:
        """Display name of a clip's virtual directory (get_mlv_basename)."""
        base, ext = os.path.splitext(os.path.basename(mlv_filename))
        if self.config.name_scheme == 1:
            clip = self._clip(os.path.join(self.mlv_dir, mlv_filename))
            rtci = clip.frame_headers(0).rtci
            return "%s%s_1_%d-%02d-%02d_%04d_C%04d" % (
                base,
                ext[1:],
                1900 + int(rtci["tm_year"]),
                int(rtci["tm_mon"]) + 1,
                int(rtci["tm_mday"]),
                1,
                0,
            )
        return base + ext

    def _mlv_from_virtual_dir(self, name: str):
        """Reverse the naming scheme → real .MLV filename or None."""
        if self.config.name_scheme == 1:
            m = _RESOLVE_RE.match(name)
            if m:
                return f"{m.group(1)}.{m.group(2)}"
            return None
        return name if is_mlv_name(name) else None

    # -- clip access ----------------------------------------------------------

    def _clip(self, mlv_path: str) -> MLVClip:
        with self._lock:
            clip = self._clips.get(mlv_path)
            if clip is None:
                clip = MLVClip(mlv_path, use_sidecar=self.config.use_sidecar_idx)
                self._clips[mlv_path] = clip
            return clip

    def _converter(self, mlv_path: str):
        from .pipeline.convert import ClipConverter

        with self._lock:
            conv = self._converters.get(mlv_path)
            if conv is None:
                conv = ClipConverter(self._clip(mlv_path), self.config)
                self._converters[mlv_path] = conv
            return conv

    def close(self):
        """Wait for background readahead, then close the converters."""
        with self._lock:
            pool, self._ra_pool = self._ra_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        self.drop_converters()

    def drop_converters(self):
        """Discard converters (and their cached config/calibration/jit state)
        so the next build picks up a new config snapshot. Without this,
        option changes were silently ignored for already-rendered clips."""
        with self._lock:
            convs = list(self._converters.values())
            self._converters.clear()
        for conv in convs:
            conv.close()

    # -- resolution -----------------------------------------------------------

    def _confined(self, base: str, relpath: str):
        """realpath(base/relpath) iff it stays inside base, else None.

        Every virtual path that maps onto the host filesystem goes through
        here: without it, a request like ``/../../etc/passwd`` would escape
        the namespace root (and the dashboard serves vfs.read over HTTP)."""
        root = os.path.realpath(base)
        real = os.path.realpath(os.path.join(root, relpath))
        if real == root or real.startswith(root + os.sep):
            return real
        return None

    def resolve(self, vpath: str):
        """Virtual path → (mlv_path | None, path_inside | None, real_path | None)."""
        vpath = vpath.strip("/")
        if not vpath:
            return None, None, self.mlv_dir
        parts = vpath.split("/")
        # walk prefixes looking for a clip directory (mlvfs_resolve_path)
        for i in range(1, len(parts) + 1):
            candidate = "/".join(parts[:i])
            mlv_name = self._mlv_from_virtual_dir(parts[i - 1])
            if mlv_name is not None:
                prefix = "/".join(parts[: i - 1] + [mlv_name])
                real = self._confined(self.mlv_dir, prefix)
                if real is not None and os.path.isfile(real):
                    return real, "/".join(parts[i:]), None
        real = self._confined(self.mlv_dir, vpath)
        if real is not None and os.path.exists(real):
            return None, None, real
        return None, None, None

    def _mld_sub(self, mlv_path: str, inside: str):
        """Confined path inside the clip's .MLD sidecar dir, or None."""
        return self._confined(mlv_path[:-4] + ".MLD", inside)

    _VIRTUAL_SUFFIXES = (".dng", ".wav", ".gif", ".log")

    def resolve_write(self, vpath: str):
        """Virtual path → on-disk path for write-side ops, or None if the
        target is a virtual file (mlvfs_resolve_virtual, main.c:1035-1082).

        Inside a clip directory, root-level .dng/.wav/.gif/.log (except
        AppleDouble ._* names) are virtual; everything else maps into the
        clip's .MLD sidecar dir. Outside clip directories paths map straight
        into the namespace root. Unlike resolve(), the target need not exist
        (create/mkdir/rename destinations).
        """
        vpath = vpath.strip("/")
        if not vpath:
            return None  # the root itself is not writable as a file
        parts = vpath.split("/")
        for i in range(1, len(parts) + 1):
            mlv_name = self._mlv_from_virtual_dir(parts[i - 1])
            if mlv_name is None:
                continue
            prefix = "/".join(parts[: i - 1] + [mlv_name])
            real_mlv = self._confined(self.mlv_dir, prefix)
            if real_mlv is None or not os.path.isfile(real_mlv):
                continue
            inside = parts[i:]
            if not inside:
                return real_mlv  # the MLV itself
            name = inside[-1]
            if (
                len(inside) == 1
                and name.lower().endswith(self._VIRTUAL_SUFFIXES)
                and not name.startswith("._")
            ):
                return None  # virtual DNG/WAV/GIF/log
            return self._mld_sub(real_mlv, "/".join(inside))
        return self._confined(self.mlv_dir, vpath)

    def _ensure_mld(self, real_path: str):
        """Create the .MLD sidecar dir on demand (check_mld_exists,
        main.c:874-893)."""
        idx = real_path.find(".MLD")
        if idx >= 0:
            mld = real_path[: idx + 4]
            if not os.path.isdir(mld):
                os.makedirs(mld, exist_ok=True)

    # -- write-side passthrough (main.c:1578-1744) -----------------------------

    def create(self, vpath: str, mode: int = 0o644):
        real = self.resolve_write(vpath)
        if real is None:
            raise PermissionError(vpath)
        self._ensure_mld(real)
        fd = os.open(real, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
        os.close(fd)

    def write(self, vpath: str, data: bytes, offset: int = 0) -> int:
        real = self.resolve_write(vpath)
        if real is None:
            raise PermissionError(vpath)
        fd = os.open(real, os.O_RDWR)
        try:
            return os.pwrite(fd, data, offset)
        finally:
            os.close(fd)

    def truncate(self, vpath: str, length: int = 0):
        real = self.resolve_write(vpath)
        if real is None:
            raise PermissionError(vpath)
        os.truncate(real, length)

    def unlink(self, vpath: str):
        real = self.resolve_write(vpath)
        if real is None:
            raise PermissionError(vpath)
        os.unlink(real)

    def mkdir(self, vpath: str, mode: int = 0o777):
        real = self.resolve_write(vpath)
        if real is None:
            raise PermissionError(vpath)
        self._ensure_mld(real)
        # mkdir of the clip's virtual root resolves to the MLV file itself;
        # the reference treats that as success (main.c:1615-1631)
        if not os.path.exists(real):
            os.mkdir(real, mode)

    def rmdir(self, vpath: str):
        real = self.resolve_write(vpath)
        if real is None:
            raise PermissionError(vpath)
        os.rmdir(real)

    def rename(self, vfrom: str, vto: str):
        real_from = self.resolve_write(vfrom)
        real_to = self.resolve_write(vto)
        if real_from is None or real_to is None:
            raise PermissionError(f"{vfrom} -> {vto}")
        self._ensure_mld(real_to)
        os.rename(real_from, real_to)

    # -- listing ----------------------------------------------------------------

    def listdir(self, vpath: str = "/"):
        mlv_path, inside, real = self.resolve(vpath)
        if mlv_path is None:
            if real is None or not os.path.isdir(real):
                raise FileNotFoundError(vpath)
            out = []
            for name in sorted(os.listdir(real)):
                if is_mlv_name(name):
                    out.append(self.virtual_dir_name(name))
                else:
                    out.append(name)
            return out
        if inside:
            # inside a clip: only the .MLD sidecar passthrough has subpaths
            sub = self._mld_sub(mlv_path, inside)
            if sub is not None and os.path.isdir(sub):
                return sorted(os.listdir(sub))
            raise FileNotFoundError(vpath)
        clip = self._clip(mlv_path)
        basename = os.path.splitext(os.path.basename(mlv_path))[0]
        names = [f"{basename}_{i:06d}.dng" for i in range(clip.frame_count)]
        if clip.has_audio:
            names.append(f"{basename}.wav")
        names.append(f"{basename}.log")
        names.append(f"{basename}_PREVIEW.gif")
        mld = mlv_path[:-4] + ".MLD"
        if os.path.isdir(mld):
            names.extend(sorted(os.listdir(mld)))
        return names

    # -- attributes ---------------------------------------------------------------

    def _stats_bytes(self) -> bytes:
        import json

        return (json.dumps(self.stats) + "\n").encode()

    def getattr(self, vpath: str):
        """(is_dir, size). DNG sizes come from headers without decoding
        (register_dng_attr semantics, resource_manager.c:319-391)."""
        if vpath == "/.mlvfs-stats":
            return False, len(self._stats_bytes())
        mlv_path, inside, real = self.resolve(vpath)
        if mlv_path is None:
            if real is None:
                raise FileNotFoundError(vpath)
            st = os.stat(real)
            return os.path.isdir(real), st.st_size
        if not inside:
            return True, 0
        name = inside.split("/")[-1]
        # per-clip attr cache: one stat serves every frame of a clip, like
        # the reference's DNG attr mapping (resource_manager.c:319-391)
        attrs = self._attr_cache.get(mlv_path)
        if attrs is None:
            clip = self._clip(mlv_path)
            fh = clip.frame_headers(0) if clip.frame_count else None
            attrs = {
                "dng": dng_emit.dng_file_size(fh.xres, fh.yres) if fh else 0,
                "wav": wav_size(clip),
                "gif": gif_size(fh.xres, fh.yres) if fh else 0,
                "log": len(clip.debug_log().encode()),
            }
            self._attr_cache[mlv_path] = attrs
        if name.endswith(".dng"):
            return False, attrs["dng"]
        if name.endswith(".wav"):
            return False, attrs["wav"]
        if name.endswith("_PREVIEW.gif"):
            return False, attrs["gif"]
        if name.endswith(".log"):
            return False, attrs["log"]
        sub = self._mld_sub(mlv_path, inside)
        if sub is not None and os.path.exists(sub):
            st = os.stat(sub)
            return os.path.isdir(sub), st.st_size
        raise FileNotFoundError(vpath)

    # -- reads ------------------------------------------------------------------------

    def open_file(self, vpath: str):
        """Pin a virtual file's buffer for the open-to-release window
        (mlvfs_open/get_or_create_image_buffer semantics): builds the buffer
        if cold and holds a reference so per-chunk reads can't race eviction.
        Pass-through and .log files just get an existence check."""
        if vpath == "/.mlvfs-stats":
            return
        cached = self._path_cache.get(vpath)
        if cached is not None and len(cached) == 3 and cached[1] == "#dng":
            mp, _, frame = cached
            self.buffers.get_or_create(cached, lambda: self._build_dng(mp, frame))
            return
        mlv_path, inside, real = self.resolve(vpath)
        if mlv_path is None or not inside:
            if real is not None and os.path.isfile(real):
                return
            raise FileNotFoundError(vpath)
        name = inside.split("/")[-1]
        if name.endswith(".dng"):
            frame = int(name[-10:-4])
            dkey = (mlv_path, "#dng", frame)
            self._path_cache[vpath] = dkey
            self.buffers.get_or_create(dkey, lambda: self._build_dng(mlv_path, frame))
        elif name.endswith(".wav"):
            clip = self._clip(mlv_path)
            self._path_cache[vpath] = (mlv_path, inside)
            self.buffers.get_or_create((mlv_path, inside), lambda: build_wav(clip))
        elif name.endswith("_PREVIEW.gif"):
            clip = self._clip(mlv_path)
            self._path_cache[vpath] = (mlv_path, inside)
            self.buffers.get_or_create((mlv_path, inside), lambda: build_gif(clip))
        else:
            self.getattr(vpath)  # existence check for .log / .MLD entries

    def read(self, vpath: str, offset: int = 0, size: int = None) -> bytes:
        """Offset-addressable read of a virtual file (mlvfs_read semantics).

        Per-chunk fast path: a pinned (open) DNG buffer is returned from a
        single dict+lock peek — the FUSE read callback for a 64 KiB chunk
        does no path resolution beyond a small vpath cache and no refcount
        churn (the pin belongs to open/release)."""
        if vpath == "/.mlvfs-stats":
            data = self._stats_bytes()
            if size is None:
                size = len(data) - offset
            return data[offset : offset + size]
        cached = self._path_cache.get(vpath)
        if cached is not None:
            data = self.buffers.peek(cached)
            if data is not None:
                if size is None:
                    size = len(data) - offset
                return data[offset : offset + size]
        data = self._file_bytes(vpath)
        if size is None:
            size = len(data) - offset
        return data[offset : offset + size]

    def _file_bytes(self, vpath: str) -> bytes:
        mlv_path, inside, real = self.resolve(vpath)
        if mlv_path is None or not inside:
            if real is not None and os.path.isfile(real):
                with open(real, "rb") as f:
                    return f.read()
            raise FileNotFoundError(vpath)
        name = inside.split("/")[-1]
        clip = self._clip(mlv_path)
        key = (mlv_path, inside)
        if len(self._path_cache) > 4096:
            self._path_cache.clear()
        if name.endswith(".dng"):
            frame = int(name[-10:-4])
            # frame-number key so batch readahead can prime siblings without
            # reconstructing their virtual names
            dkey = (mlv_path, "#dng", frame)
            self._path_cache[vpath] = dkey
            return self.buffers.fetch(dkey, lambda: self._build_dng(mlv_path, frame))
        if name.endswith(".wav"):
            self._path_cache[vpath] = key
            return self.buffers.fetch(key, lambda: build_wav(clip))
        if name.endswith("_PREVIEW.gif"):
            self._path_cache[vpath] = key
            return self.buffers.fetch(key, lambda: build_gif(clip))
        if name.endswith(".log"):
            return clip.debug_log().encode()
        sub = self._mld_sub(mlv_path, inside)
        if sub is not None and os.path.isfile(sub):
            with open(sub, "rb") as f:
                return f.read()
        raise FileNotFoundError(vpath)

    def release(self, vpath: str):
        mlv_path, inside, _ = self.resolve(vpath)
        if mlv_path and inside:
            name = inside.split("/")[-1]
            if name.endswith(".dng"):
                self.buffers.release((mlv_path, "#dng", int(name[-10:-4])))
            else:
                self.buffers.release((mlv_path, inside))

    # -- DNG building (batched readahead) -------------------------------------

    def _build_dng(self, mlv_path: str, frame: int) -> bytes:
        """Cold-read DNG build. With readahead > 1 the whole aligned batch
        containing ``frame`` runs through the conversion engine in ONE device
        program, sibling frames are primed into the buffer cache, and the
        next batch is scheduled on a background thread — sequential reads of
        a mounted clip then decode at the batch engine's rate instead of one
        demand-paged frame per FUSE round trip."""
        B = self.readahead
        if B <= 1:
            return self._build_batch(mlv_path, [frame])[frame]
        count = self._clip(mlv_path).frame_count
        start = frame - (frame % B)
        # if the background prefetcher is already building this batch, wait
        # for it instead of duplicating the device work
        with self._lock:
            fut = self._ra_futures.get((mlv_path, start))
        if fut is not None:
            try:
                fut.result()
            except Exception:
                pass  # prefetch failure falls back to a foreground build
            data = self.buffers.peek((mlv_path, "#dng", frame))
            if data is not None:
                self._schedule_readahead(mlv_path, start + B, count)
                return data
        indices = list(range(start, min(start + B, count)))
        built = self._build_batch(mlv_path, indices)
        for i, data in built.items():
            if i != frame:
                self.buffers.put((mlv_path, "#dng", i), data)
        self._schedule_readahead(mlv_path, start + B, count)
        return built[frame]

    def _build_batch(self, mlv_path: str, indices) -> dict:
        """Decode+process ``indices`` as one batch → {frame: dng_bytes}."""
        conv = self._converter(mlv_path)
        clip = conv.clip
        with self._build_lock:  # converters are not concurrency-safe
            self.stats["builds"] += 1
            self.stats["frames_built"] += len(indices)
            imgs = conv.decode_batch(indices)
            imgs, info = conv.process_batch(imgs, indices)
            imgs_np = np.asarray(imgs).astype("<u2")
        basename = os.path.splitext(os.path.basename(mlv_path))[0]
        out = {}
        for bi, i in enumerate(indices):
            fh = clip.frame_headers(i)
            conv._apply_info(fh, info, bi)
            header = dng_emit.build_dng_header(fh, self.config.fps, basename)
            out[i] = header + imgs_np[bi].tobytes()
        return out

    def _schedule_readahead(self, mlv_path: str, start: int, count: int):
        if start >= count:
            return
        bkey = (mlv_path, start)
        with self._lock:
            if bkey in self._ra_futures or self.buffers.contains((mlv_path, "#dng", start)):
                return
            if self._ra_pool is None:
                import concurrent.futures as _f

                self._ra_pool = _f.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="mlvfs-ra"
                )

        def _prefetch():
            try:
                indices = list(range(start, min(start + self.readahead, count)))
                built = self._build_batch(mlv_path, indices)
                for i, data in built.items():
                    self.buffers.put((mlv_path, "#dng", i), data)
            finally:
                with self._lock:
                    self._ra_futures.pop(bkey, None)

        with self._lock:
            if bkey not in self._ra_futures:
                self._ra_futures[bkey] = self._ra_pool.submit(_prefetch)
