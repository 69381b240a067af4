"""Benchmark legs for 1080p 14-bit RAW→DNG conversion on one accelerator.

Prints the device (platform, kind, count) and the card's name and power
limit, then one JSON line. Fails when JAX finds no accelerator, and when any
leg fails.

Legs (BENCH_MODE):
  (unset)  device unpack throughput, the fused unpack→deflicker→cs3x3→stripes
           program, and the full dual-ISO amaze-edge path, frames/s;
  host     disk → packed views → DNG header render → file write, device
           compute elided;
  lj92 / lzma   compressed-clip host decode;
  encode   --compress-dng host LJ92 encode.
"""

import json
import os
import sys
import time

import numpy as np


def _reps(fn, n=5):
    """One discipline for every leg: the recorded number is the median of n
    reps, and the best rep rides along as a secondary field."""
    import statistics

    vals = sorted(fn() for _ in range(n))
    return {"median": statistics.median(vals), "best": vals[-1]}


def main():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mlvfs_tpu.utils.cache import enable_compile_cache
    from mlvfs_tpu.utils.device import gpu_name_and_power_limit, require_accelerator

    device = require_accelerator()
    print(f"device: {device}")
    print(f"card: {gpu_name_and_power_limit()}")
    enable_compile_cache()

    from mlvfs_tpu.format import synth
    from mlvfs_tpu.format.bits import pack_bits_np
    from mlvfs_tpu.ops.unpack import unpack_batch, words_for_pixels

    width, height, bpp = 1920, 1080, 14
    batch = int(os.environ.get("BENCH_BATCH", "16"))  # the engine's default
    n_batches = int(os.environ.get("BENCH_BATCHES", "50"))

    rng = np.random.default_rng(7)
    spec = synth.SynthSpec(width=width, height=height, frames=1, bpp=bpp)
    frame = synth.make_frame_data(spec, rng)
    words1 = pack_bits_np(frame.ravel(), bpp)
    n_words = words_for_pixels(width * height, bpp)
    words = np.broadcast_to(words1[:n_words], (batch, n_words))

    if os.environ.get("BENCH_MODE") == "host":
        reps = _bench_host(frame, spec)
        print(
            json.dumps(
                {
                    "metric": "1080p_14bit_host_pipeline_fps",
                    "value": round(reps["median"], 2),
                    "unit": "frames/sec",
                    "device": device,
                    "best_rep": round(reps["best"], 2),
                    # staged-gather bracket: see _bench_host's scope note
                    "staged_median": round(reps["staged_median"], 2),
                    "staged_best": round(reps["staged_best"], 2),
                }
            )
        )
        return
    elif os.environ.get("BENCH_MODE") in ("lj92", "lzma"):
        comp = os.environ["BENCH_MODE"]
        fps = _bench_compressed(frame, spec, comp)
        metric = f"1080p_14bit_{comp}_host_decode_fps"
    elif os.environ.get("BENCH_MODE") == "encode":
        fps = _bench_encode(frame, spec)
        metric = "1080p_16bit_lj92_host_encode_fps"
    else:
        # chain a reduction through the loop so every batch executes before
        # the final host read stops the clock
        run = jax.jit(
            lambda wsd, c: (unpack_batch(wsd, bpp, height, width).astype(jnp.uint32) + c).sum(
                dtype=jnp.uint32
            )
        )
        dev = jax.device_put(np.ascontiguousarray(words))
        int(run(dev, jnp.uint32(0)))  # compile + warm

        def one_rep():
            t0 = time.perf_counter()
            c = jnp.uint32(0)
            for _ in range(n_batches):
                c = run(dev, c)
            int(c)
            return batch * n_batches / (time.perf_counter() - t0)

        head = _reps(one_rep)
        fps = head["median"]
        metric = "1080p_14bit_raw_to_dng_frames_per_sec_per_chip"

        # second recorded number: the fused processing program
        # (unpack → deflicker median → chroma smooth 3x3 → stripes apply),
        # i.e. a flags-on conversion config rather than one kernel
        extra = {}
        import __graft_entry__ as graft

        pfn = graft._pipeline_fn(bpp=bpp, h=height, w=width, chroma_method=3)
        gains = jax.device_put(np.full(8, 65537, np.int32))

        def fused(wsd, g, c):
            imgs, med = pfn(wsd, g)
            return (imgs.astype(jnp.uint32) + c).sum(dtype=jnp.uint32) + med.sum().astype(jnp.uint32)

        runf = jax.jit(fused)
        pb = batch
        devp = jax.device_put(np.ascontiguousarray(words[:pb]))
        int(runf(devp, gains, jnp.uint32(0)))
        nb = max(10, n_batches // 4)

        def one_rep_f():
            t0 = time.perf_counter()
            c = jnp.uint32(0)
            for _ in range(nb):
                c = runf(devp, gains, c)
            int(c)
            return pb * nb / (time.perf_counter() - t0)

        pl = _reps(one_rep_f)
        extra["pipeline_fps"] = round(pl["median"], 2)
        extra["pipeline_fps_best"] = round(pl["best"], 2)
        extra["pipeline_ops"] = "unpack+deflicker+cs3x3+stripes"

        # third recorded number: the flagship quality path — full dual-ISO
        # cr2hdr20 amaze-edge (device analysis + reconstruction, per-clip
        # caches warm) at 1080p, engine-default batch 16
        import types

        from mlvfs_tpu.ops import dualiso_full as dif
        from mlvfs_tpu.pipeline.config import ProcessingConfig

        di_b = 16
        di_spec = synth.SynthSpec(width=width, height=height, frames=1, dual_iso=3, seed=3)
        di_frame = synth.make_frame_data(di_spec, np.random.default_rng(3))
        di_imgs = jax.device_put(
            np.ascontiguousarray(np.broadcast_to(di_frame, (di_b, height, width)))
        )
        fh = types.SimpleNamespace(
            raw_info=types.SimpleNamespace(
                black_level=di_spec.black, white_level=di_spec.white, bits_per_pixel=14
            ),
            vidf={"panPosX": 0, "panPosY": 0},
            idnt={"cameraModel": 0x80000285},
        )
        cal = types.SimpleNamespace(focus_pixel_list=None, dual_iso_rggb=None)
        di_cfg = ProcessingConfig(dual_iso=2, hdr_interpolation_method=0)
        out, okm = dif.cr2hdr20_batch(di_imgs, fh, di_cfg, cal)  # warm + cal caches
        np.asarray(out[:, ::256, ::256])
        assert bool(np.asarray(okm).all()), "dual-ISO analysis rejected the bench frame"
        nd = 6

        def one_rep_d():
            t0 = time.perf_counter()
            for _ in range(nd):
                o, _ok = dif.cr2hdr20_batch(di_imgs, fh, di_cfg, cal)
                np.asarray(o[:, ::256, ::256])  # chain: forces execution
            return di_b * nd / (time.perf_counter() - t0)

        di = _reps(one_rep_d)
        di_fps = di["median"]
        extra["dualiso_fps"] = round(di_fps, 2)
        extra["dualiso_fps_best"] = round(di["best"], 2)
        extra["dualiso_ms_per_frame"] = round(1000.0 / di_fps, 2)
        extra["dualiso_ops"] = "cr2hdr20 amaze-edge full path (analysis+reconstruction), 1080p batch 16"

        print(
            json.dumps(
                {
                    "metric": metric,
                    "value": round(fps, 2),
                    "unit": "frames/sec",
                    "device": device,
                    "best_rep": round(head["best"], 2),
                    **extra,
                }
            )
        )
        return

    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(fps, 2),
                "unit": "frames/sec",
                "device": device,
            }
        )
    )


def _bench_host(frame, spec):
    """Host-side pipeline at rate, device compute elided: disk → packed
    frame views (zero-copy off the chunk memmaps) → header template render
    → DNG file writes (/dev/shm).

    The host complement to the device-kernel number: the _finish_batch
    path at rate. Reports the median of 5 reps and the best rep.

    Scope: the headline excludes the jax.device_put submissions the real
    fetch path issues (_put_views). To bracket what that exclusion could
    hide, ``staged`` re-runs the identical loop with the staged gather
    (_gather_packed_batch: one explicit host payload copy per frame).
    """
    import statistics
    import tempfile
    import time as _time

    from mlvfs_tpu.format import synth
    from mlvfs_tpu.format.reader import MLVClip
    from mlvfs_tpu.pipeline.config import ProcessingConfig
    from mlvfs_tpu.pipeline.convert import ClipConverter

    frames = int(os.environ.get("BENCH_FRAMES", "192"))
    batch = 24
    tmp = tempfile.mkdtemp(prefix="mlvfs_bench_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    src = os.path.join(tmp, "BENCH.MLV")
    data = np.broadcast_to(frame, (frames, spec.height, spec.width))
    synth.write_mlv(src, spec, frame_data=np.ascontiguousarray(data))
    conv = ClipConverter(MLVClip(src, populate=True), ProcessingConfig(batch_size=batch))
    outdir = os.path.join(tmp, "out")
    os.makedirs(outdir, exist_ok=True)
    imgs_np = np.zeros((batch, spec.height, spec.width), "<u2")
    info = {"black_level": 2048, "white_level": 15000, "exposure_bias": None}
    batches = [list(range(i, i + batch)) for i in range(0, frames, batch)]
    # warm (template build, fpm load, page cache)
    conv._gather_packed_views(batches[0])
    conv._finish_batch(outdir, "BENCH", batches[0], imgs_np, info)

    def one_rep(gather):
        t0 = _time.perf_counter()
        pending = []
        for indices in batches:
            gather(indices)
            pending.append(
                conv._write_pool.submit(conv._finish_batch, outdir, "BENCH", indices, imgs_np, info)
            )
        for fut in pending:
            fut.result()
        return frames / (_time.perf_counter() - t0)

    reps = sorted(one_rep(conv._gather_packed_views) for _ in range(5))
    staged = sorted(one_rep(conv._gather_packed_batch) for _ in range(5))
    conv.close()
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {
        "median": statistics.median(reps),
        "best": reps[-1],
        "staged_median": statistics.median(staged),
        "staged_best": staged[-1],
    }


def _bench_compressed(frame, spec, comp):
    """Compressed-clip host decode throughput at rate (the stage that is
    host-bound for LJ92/LZMA clips: entropy decode fanned across cores,
    one native call per batch for LJ92). Device unpack/detile excluded —
    it is the same device leg the default mode measures.
    """
    import dataclasses
    import tempfile
    import time as _time

    from mlvfs_tpu.format import synth
    from mlvfs_tpu.format.reader import MLVClip
    from mlvfs_tpu.pipeline.config import ProcessingConfig
    from mlvfs_tpu.pipeline.convert import ClipConverter

    frames = int(os.environ.get("BENCH_FRAMES", "48"))
    batch = 24
    tmp = tempfile.mkdtemp(prefix="mlvfs_bench_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    src = os.path.join(tmp, "BENCH.MLV")
    cspec = dataclasses.replace(spec, compression=comp, frames=frames)
    data = np.broadcast_to(frame, (frames, spec.height, spec.width))
    synth.write_mlv(src, cspec, frame_data=np.ascontiguousarray(data))
    conv = ClipConverter(MLVClip(src, populate=True), ProcessingConfig(batch_size=batch))
    decode = conv._decode_batch_host if comp == "lj92" else conv._lzma_batch_host
    batches = [list(range(i, i + batch)) for i in range(0, frames, batch)]
    decode(batches[0])  # warm (library load, page cache)

    def one_rep():
        t0 = _time.perf_counter()
        for indices in batches:
            decode(indices)
        return frames / (_time.perf_counter() - t0)

    fps = _reps(one_rep)["median"]
    conv.close()
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return fps


def _bench_encode(frame, spec):
    """Compressed-DNG output: native threaded batch LJ92 encode at rate
    (the host-bound stage of --compress-dng; scales with cores)."""
    import time as _time

    from mlvfs_tpu.codecs import lj92 as lj92_codec

    frames = int(os.environ.get("BENCH_FRAMES", "48"))
    batch = 24
    imgs = np.broadcast_to(frame.astype(np.uint16), (batch, spec.height, spec.width))
    imgs = np.ascontiguousarray(imgs)
    lj92_codec.encode_batch(imgs[:2], ncomp=2, bits=16)  # warm (lib build)

    def one_rep():
        t0 = _time.perf_counter()
        done = 0
        while done < frames:
            lj92_codec.encode_batch(imgs, ncomp=2, bits=16)
            done += batch
        return done / (_time.perf_counter() - t0)

    return _reps(one_rep)["median"]


if __name__ == "__main__":
    main()
