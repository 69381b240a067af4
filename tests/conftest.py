import os

# The suite runs on the CPU with an 8-device virtual mesh unless the caller
# picks a platform (the `gpu`-marked tests need JAX_PLATFORMS=cuda and a card).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mlvfs_tpu.format import synth  # noqa: E402
from mlvfs_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips when JAX has none (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on a machine with a card")
    return devs[0]


@pytest.fixture
def eight_devices():
    """Skips unless the process has the 8-device virtual CPU mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


@pytest.fixture
def tmp_clip(tmp_path):
    """A small synthetic 14-bit clip on disk."""
    path = str(tmp_path / "M01-1234.MLV")
    spec = synth.write_mlv(path, width=320, height=96, frames=4)
    return path, spec


@pytest.fixture
def rng():
    return np.random.default_rng(42)
