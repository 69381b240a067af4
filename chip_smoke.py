"""Smoke test of the conversion path on the GPU, checked against the CPU.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: the --devices 4 frame sharding only

Everything runs in this one process (a JAX process reserves most of a card's
memory; nvidia-smi is the only child). Phases, in order:

  1. device report: JAX's platform, device kind and count, and the card's
     name and power limit; anything but a GPU fails the run;
  2. the evarith cores checked exhaustively on the card;
  3. `mlvfs-tpu convert` (the CLI's own entry point, in-process) on the five
     BASELINE.json configurations at 1920x1080 14 bpp, 64 frames, batch 16,
     plus a 1808x1190 12 bpp clip whose camera has a bundled focus-pixel map;
     four DNGs of the plain clip read back through VirtualFS.read;
  4. the LJ92 DNGs decoded and checked bit-exact against an uncompressed run
     of the same configuration on the same card;
  5. the same configurations on the process's CPU device for the first two
     frames of each clip: integer paths bit-exact, dual-ISO with identical
     per-frame ok masks and payload PSNR >= 60 dB;
  6. frames/s per configuration (median of 3 warm CLI runs) and peak device
     memory, for information.

Any failed check raises, so the run exits non-zero. The last line of a
passing run is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import struct
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class Sizes:
    width: int = 1920
    height: int = 1080
    bpp: int = 14
    frames: int = 64
    batch: int = 16


# a recorded geometry of camera 0x80000331: mlvfs_tpu/data/80000331_1808x1190.fpm
FPM_CAMERA = 0x80000331
FPM_WIDTH, FPM_HEIGHT, FPM_BPP = 1808, 1190, 12
N_REF = 2  # frames of each clip converted on the CPU device
N_VFS = 4  # DNGs of the plain clip read through VirtualFS
WARM_RUNS = 3
PSNR_MIN_DB = 60.0  # the AMaZE plane gate of PARITY.md
TAG_BLACK_LEVEL = 50714

# (name, clip, CLI flags): BASELINE.json's processing configs, then the
# focus-pixel clip under the plain config
CONFIGS = (
    ("plain", "plain", ()),
    ("cs3x3 bad-pix", "plain", ("--cs3x3", "--bad-pix")),
    ("stripes pattern-noise", "plain", ("--stripes", "--fix-pattern-noise")),
    ("dual-iso mean23", "dual", ("--dual-iso", "--mean23")),
    ("dual-iso amaze-edge lj92", "dual", ("--dual-iso", "--amaze-edge", "--compress-dng")),
    ("focus-pixel map", "fpm", ()),
)
FOUR_CONFIGS = (
    ("plain", ()),
    ("stripes batch-cal", ("--stripes", "--stripes-batch-cal")),
)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ clips


def make_clips(root: str, sizes: Sizes, names=("plain", "dual", "fpm")) -> dict:
    """name -> (clip path, its frames as synth made them), from fixed seeds."""
    from mlvfs_tpu.format import synth

    specs = {
        "plain": synth.SynthSpec(width=sizes.width, height=sizes.height, bpp=sizes.bpp,
                                 frames=sizes.frames, seed=1),
        "dual": synth.SynthSpec(width=sizes.width, height=sizes.height, bpp=sizes.bpp,
                                frames=sizes.frames, dual_iso=3, seed=3),
        "fpm": synth.SynthSpec(width=FPM_WIDTH, height=FPM_HEIGHT,
                               bpp=FPM_BPP, white=(1 << FPM_BPP) - 1,
                               black=512, frames=sizes.frames, camera_model=FPM_CAMERA,
                               seed=5),
    }
    clips = {}
    for i, name in enumerate(names):
        spec = specs[name]
        d = os.path.join(root, "clips", name)
        os.makedirs(d)
        path = os.path.join(d, f"M0{i + 1}-0001.MLV")
        rng = np.random.default_rng(spec.seed)
        frames = np.stack([synth.make_frame_data(spec, rng) for _ in range(spec.frames)])
        synth.write_mlv(path, spec, frame_data=frames)
        clips[name] = (path, spec, frames)
    return clips


# ------------------------------------------------------------------ conversion


def cli_convert(clip: str, outdir: str, flags, batch: int) -> list:
    """`mlvfs-tpu convert` through the CLI's entry point → sorted DNG paths."""
    from mlvfs_tpu import cli

    shutil.rmtree(outdir, ignore_errors=True)
    rc = cli.main(["convert", clip, "-o", outdir, "--batch-size", str(batch), *flags])
    check(rc == 0, f"convert {flags} exited {rc}")
    return sorted(os.path.join(outdir, f) for f in os.listdir(outdir) if f.endswith(".dng"))


def cpu_convert(clip: str, outdir: str, flags, n: int) -> list:
    """The same CLI configuration on the CPU device, first ``n`` frames,
    without the calibration sidecar (so nothing carries over from the GPU)."""
    import jax

    from mlvfs_tpu import cli
    from mlvfs_tpu.format.reader import MLVClip
    from mlvfs_tpu.pipeline.convert import ClipConverter

    args = cli.build_parser().parse_args(["convert", clip, "-o", outdir, *flags])
    cfg = dataclasses.replace(cli.config_from_args(args), batch_size=n, use_sidecar_idx=False)
    prev = jax.config.jax_default_device
    # global, not the thread-local context manager: the converter's prefetch
    # and write threads must land on the CPU too
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    try:
        with MLVClip(clip, use_sidecar=False) as c:
            conv = ClipConverter(c, cfg)
            try:
                return conv.convert(outdir, frames=range(n))
            finally:
                conv.close()
    finally:
        jax.config.update("jax_default_device", prev)


# ------------------------------------------------------------------ DNG reading


def dng_parts(path: str):
    from mlvfs_tpu.emit.dng import HEADER_SIZE

    with open(path, "rb") as f:
        data = f.read()
    return data[:HEADER_SIZE], data[HEADER_SIZE:]


def black_level(header: bytes) -> int:
    """BlackLevel from IFD0 of a little-endian DNG header."""
    check(header[:4] == b"II*\0", "not a little-endian TIFF header")
    (ifd,) = struct.unpack_from("<I", header, 4)
    (n,) = struct.unpack_from("<H", header, ifd)
    for k in range(n):
        tag, _typ, _count, value = struct.unpack_from("<HHII", header, ifd + 2 + 12 * k)
        if tag == TAG_BLACK_LEVEL:
            return value
    raise SmokeFailure("DNG header has no BlackLevel tag")


def payload_image(payload: bytes, compressed: bool, h: int, w: int) -> np.ndarray:
    if compressed:
        from mlvfs_tpu.codecs import lj92

        samples, *_ = lj92.decode(payload)
        return samples.reshape(h, w)
    return np.frombuffer(payload, "<u2").reshape(h, w)


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(65535.0**2 / mse))


def compare_with_cpu(name, flags, spec, gpu_files, cpu_files) -> str:
    """Checks the first frames of a GPU run against the CPU run; returns a
    one-line verdict."""
    dual = "--dual-iso" in flags
    compressed = "--compress-dng" in flags
    oks, psnrs = [], []
    for g, c in zip(gpu_files, cpu_files):
        hg, pg = dng_parts(g)
        hc, pc = dng_parts(c)
        ok_g = black_level(hg) == 4 * spec.black
        ok_c = black_level(hc) == 4 * spec.black
        check(ok_g == ok_c, f"{name}: dual-ISO ok differs for {os.path.basename(g)}")
        oks.append(ok_g)
        if not dual:
            check(hg == hc, f"{name}: DNG header differs from the CPU for {os.path.basename(g)}")
            check(pg == pc, f"{name}: DNG payload differs from the CPU for {os.path.basename(g)}")
            continue
        img_g = payload_image(pg, compressed, spec.height, spec.width)
        img_c = payload_image(pc, False, spec.height, spec.width)
        psnrs.append(psnr_db(img_g, img_c))
    if not dual:
        return f"bit-exact vs CPU ({len(gpu_files)} frames, header and payload)"
    check(all(oks), f"{name}: dual-ISO analysis rejected a synthetic frame: {oks}")
    check(min(psnrs) >= PSNR_MIN_DB, f"{name}: PSNR {psnrs} below {PSNR_MIN_DB} dB")
    return (f"ok masks {oks} identical to CPU; payload PSNR vs CPU "
            + ", ".join(f"{p:.2f}" for p in psnrs) + f" dB (gate {PSNR_MIN_DB})")


def check_lj92_lossless(name, spec, lj92_files, plain_files) -> str:
    """Each LJ92 payload must decode to the uncompressed payload of the same
    frame; returns a one-line verdict."""
    check(len(lj92_files) == len(plain_files),
          f"{name}: {len(lj92_files)} LJ92 DNGs for {len(plain_files)} uncompressed")
    for a, b in zip(lj92_files, plain_files):
        _, pa = dng_parts(a)
        _, pb = dng_parts(b)
        check(np.array_equal(payload_image(pa, True, spec.height, spec.width),
                             payload_image(pb, False, spec.height, spec.width)),
              f"{name}: {os.path.basename(a)} does not decode to the uncompressed payload")
    return f"{len(lj92_files)} LJ92 payloads decode bit-exact to the uncompressed payloads"


# ------------------------------------------------------------------ phases


def phase_device(want_count=None):
    import jax

    from mlvfs_tpu.utils.device import gpu_name_and_power_limit, require_accelerator

    device = require_accelerator()
    log(f"device: platform={device['platform']} kind={device['kind']} count={device['count']}")
    check(device["platform"] == "gpu", f"platform {device['platform']!r} is not a GPU")
    if want_count is not None:
        check(device["count"] >= want_count, f"needs {want_count} GPUs, found {device['count']}")
    card = gpu_name_and_power_limit()
    log(card)
    log(f"jax {jax.__version__}")
    return device, card.splitlines()[0]


def phase_evarith():
    from mlvfs_tpu.ops import evarith

    t0 = time.perf_counter()
    evarith.check_cores()  # raises AssertionError on the first mismatching core
    log(f"evarith: all four double-single cores bit-exact on the card "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_convert(clips, sizes: Sizes, root: str, card: str) -> dict:
    """Converts every configuration through the CLI; returns name -> files."""
    import jax

    results = {}
    process_peak = 0
    for name, clip_name, flags in CONFIGS:
        clip, spec, _frames = clips[clip_name]
        outdir = os.path.join(root, "gpu", name.replace(" ", "_"))
        t0 = time.perf_counter()
        files = cli_convert(clip, outdir, flags, sizes.batch)
        cold = time.perf_counter() - t0
        check(len(files) == spec.frames, f"{name}: {len(files)} DNGs for {spec.frames} frames")
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            files = cli_convert(clip, outdir, flags, sizes.batch)
            warm.append(spec.frames / (time.perf_counter() - t0))
        # JAX keeps one running peak per process: a config whose runs raise
        # it has that peak as its own; one that does not stayed below it
        peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
        if peak is None:
            own_peak = "not measured"
        elif peak > process_peak:
            own_peak, process_peak = f"{peak} bytes", peak
        else:
            own_peak = f"at most {peak} bytes (below an earlier config's peak)"
        log(f"convert {name}: {len(files)} DNGs, first run {cold:.1f} s (compiles included); "
            f"warm {statistics.median(warm):.1f} frames/s median of "
            f"{[round(v, 1) for v in warm]} ({spec.width}x{spec.height} {spec.bpp} bpp, "
            f"batch {sizes.batch}, CLI end to end); peak device memory {own_peak}; card {card}")
        results[name] = files
    return results


def phase_unpack_and_vfs(clips, gpu_files, sizes: Sizes):
    """The plain DNG payloads against synth's frames, the device unpack
    against them directly, and mount reads against the converted files."""
    from mlvfs_tpu.emit.dng import HEADER_SIZE
    from mlvfs_tpu.format.reader import MLVClip
    from mlvfs_tpu.pipeline.config import ProcessingConfig
    from mlvfs_tpu.pipeline.convert import ClipConverter
    from mlvfs_tpu.vfs import VirtualFS

    clip, spec, frames = clips["plain"]
    for i, path in enumerate(gpu_files["plain"]):
        _, payload = dng_parts(path)
        check(np.array_equal(np.frombuffer(payload, "<u2").reshape(frames[i].shape), frames[i]),
              f"plain DNG {i} payload differs from the frame synth packed")
    with MLVClip(clip) as c:
        conv = ClipConverter(c, ProcessingConfig(batch_size=sizes.batch))
        try:
            idx = list(range(min(sizes.batch, spec.frames)))
            got = np.asarray(conv.decode_batch(idx))[: len(idx)]
        finally:
            conv.close()
    check(np.array_equal(got, frames[: len(idx)]), "device unpack differs from synth's frames")
    log(f"unpack: bit-exact against synth's frames ({spec.frames} DNG payloads, "
        f"{len(idx)} frames straight from unpack_batch)")

    clip_dir, clip_file = os.path.split(clip)
    base = clip_file[:-4]
    fs = VirtualFS(clip_dir, ProcessingConfig(batch_size=sizes.batch))
    try:
        for i in range(N_VFS):
            data = fs.read(f"/{clip_file}/{base}_{i:06d}.dng")
            with open(gpu_files["plain"][i], "rb") as f:
                want = f.read()
            check(len(data) == HEADER_SIZE + 2 * spec.width * spec.height,
                  f"VirtualFS DNG {i} has {len(data)} bytes")
            check(data == want, f"VirtualFS DNG {i} differs from the converted file")
    finally:
        fs.close()
    log(f"vfs: {N_VFS} DNGs read through VirtualFS.read equal the converted files")


def phase_lj92(clips, gpu_files, sizes: Sizes, root: str):
    """Every --compress-dng config converted again without it on the card:
    the codec's error is checked alone, apart from any GPU-vs-CPU difference."""
    for name, clip_name, flags in CONFIGS:
        if "--compress-dng" not in flags:
            continue
        clip, spec, _frames = clips[clip_name]
        plain = cli_convert(clip, os.path.join(root, "gpu", name.replace(" ", "_") + "_uncompressed"),
                            tuple(f for f in flags if f != "--compress-dng"), sizes.batch)
        log(f"lj92 {name}: " + check_lj92_lossless(name, spec, gpu_files[name], plain)
            + " of the same card's run")


def phase_cpu_reference(clips, gpu_files, sizes: Sizes, root: str):
    for name, clip_name, flags in CONFIGS:
        clip, spec, _frames = clips[clip_name]
        # the reference DNGs stay uncompressed: the GPU's LJ92 payloads are
        # decoded (and checked lossless by phase_lj92) and compared with them
        ref_flags = tuple(f for f in flags if f != "--compress-dng")
        t0 = time.perf_counter()
        cpu_files = cpu_convert(clip, os.path.join(root, "cpu", name.replace(" ", "_")),
                                ref_flags, N_REF)
        check(len(cpu_files) == N_REF, f"{name}: CPU run wrote {len(cpu_files)} DNGs")
        verdict = compare_with_cpu(name, flags, spec, gpu_files[name][: N_REF], cpu_files)
        log(f"reference {name}: {verdict} (CPU run {time.perf_counter() - t0:.1f} s)")


def run_one_card(sizes: Sizes, root: str, card: str):
    t0 = time.perf_counter()
    clips = make_clips(root, sizes)
    log(f"clips: synthesised in {time.perf_counter() - t0:.1f} s")
    gpu_files = phase_convert(clips, sizes, root, card)
    phase_unpack_and_vfs(clips, gpu_files, sizes)
    phase_lj92(clips, gpu_files, sizes, root)
    phase_cpu_reference(clips, gpu_files, sizes, root)


def run_four_cards(sizes: Sizes, root: str, card: str):
    """--devices 4 against one device, same process, same clip."""
    import jax

    from mlvfs_tpu.format.reader import MLVClip
    from mlvfs_tpu.pipeline.config import ProcessingConfig
    from mlvfs_tpu.pipeline.convert import ClipConverter

    clips = make_clips(root, sizes, names=("plain",))
    clip, spec, _frames = clips["plain"]
    with MLVClip(clip) as c:
        conv = ClipConverter(c, ProcessingConfig(batch_size=sizes.batch, shard_devices=4))
        try:
            batch = conv.fetch_batch(list(range(min(sizes.batch, spec.frames))))
            holders = {s.device for s in batch.addressable_shards}
        finally:
            conv.close()
    check(holders == set(jax.devices()[:4]), f"batch shards live on {holders}")
    log(f"shards: one {sizes.batch}-frame batch spread over {sorted(d.id for d in holders)}")
    for name, flags in FOUR_CONFIGS:
        out1 = os.path.join(root, "one", name.replace(" ", "_"))
        out4 = os.path.join(root, "four", name.replace(" ", "_"))
        t0 = time.perf_counter()
        one = cli_convert(clip, out1, flags, sizes.batch)
        t1 = time.perf_counter()
        four = cli_convert(clip, out4, (*flags, "--devices", "4"), sizes.batch)
        t4 = time.perf_counter()
        check(len(one) == len(four) == spec.frames, f"{name}: DNG counts {len(one)}, {len(four)}")
        for a, b in zip(one, four):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                check(fa.read() == fb.read(), f"{name}: {os.path.basename(b)} differs on 4 devices")
        log(f"four {name}: {len(four)} DNGs on 4 devices identical to 1 device "
            f"(first runs, compiles included: 1 device {t1 - t0:.1f} s, 4 devices {t4 - t1:.1f} s; "
            f"card {card})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the --devices 4 sharding path on four cards")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    device, card = phase_device(want_count=4 if args.four else None)
    from mlvfs_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four:
            run_four_cards(Sizes(), root, card)
        else:
            phase_evarith()
            run_one_card(Sizes(), root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
