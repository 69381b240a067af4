"""mlvfs_tpu — an accelerator-side Magic Lantern Video (MLV) → CinemaDNG conversion framework.

A ground-up rebuild of the capabilities of MLVFS (davidmilligan/MLVFS): instead
of a FUSE filesystem that synthesizes DNG files on demand, this framework is a
batch conversion engine that streams indexed MLV blocks to a GPU and runs
the entire raw-processing pipeline (bit unpacking, dual-ISO HDR reconstruction,
chroma smoothing, bad/focus pixel correction, vertical-stripe fix, pattern-noise
removal, deflicker) as fused JAX/XLA programs over batches of frames.

Layering (mirrors SURVEY.md section 1, redesigned for batched device programs):

  - ``mlvfs_tpu.format``   — MLV container model, chunk discovery, XREF index,
                             ``.IDX`` sidecar (reference: mlv.h, raw.h, index.c)
  - ``mlvfs_tpu.ops``      — device compute: LUTs, bit unpack, stencil kernels,
                             dual-ISO engine (reference: dng.c:813, hdr.c, cs.c,
                             stripes.c, patternnoise.c, chroma_smooth.c)
  - ``mlvfs_tpu.emit``     — file synthesis: CDNG headers, BWF WAV, GIF preview
                             (reference: dng.c:612, wav.c, gif.c)
  - ``mlvfs_tpu.pipeline`` — batch conversion engine, streaming, prefetch
                             (replaces the FUSE read path, main.c:908)
  - ``mlvfs_tpu.parallel`` — device meshes and multi-chip sharding
  - ``mlvfs_tpu.vfs``      — virtual-namespace view of a mount directory
                             (replaces main.c path resolution, readdir)
"""

__version__ = "0.1.0"

SOFTWARE_NAME = "MLVFS"  # written into the DNG Software tag; matches reference output
