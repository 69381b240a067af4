"""chip_smoke.py off the card: it must refuse to run without an accelerator
or without the repository, and its checks and --four path must work at a
small size on the CPU."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SMALL = chip_smoke.Sizes(width=256, height=64, frames=4, batch=4)


def _run_smoke(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_smoke_fails_off_the_card(where, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    if where == "repo":
        cwd = REPO
    else:  # the script without the program beside it
        cwd = str(tmp_path)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
    proc = _run_smoke(cwd, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_black_level_and_payload_from_a_converted_dng(tmp_path):
    from mlvfs_tpu.format import synth
    from mlvfs_tpu.pipeline.convert import convert_clip

    src = str(tmp_path / "M01-0001.MLV")
    spec = synth.write_mlv(src, width=128, height=32, frames=1)
    (path,) = convert_clip(src, str(tmp_path / "out"))
    header, payload = chip_smoke.dng_parts(path)
    assert chip_smoke.black_level(header) == spec.black
    img = chip_smoke.payload_image(payload, False, spec.height, spec.width)
    assert img.shape == (spec.height, spec.width)


def test_compare_with_cpu_catches_a_changed_payload(tmp_path):
    from mlvfs_tpu.format import synth
    from mlvfs_tpu.pipeline.convert import convert_clip

    src = str(tmp_path / "M01-0001.MLV")
    spec = synth.write_mlv(src, width=128, height=32, frames=1)
    (a,) = convert_clip(src, str(tmp_path / "a"))
    (b,) = convert_clip(src, str(tmp_path / "b"))
    assert "bit-exact" in chip_smoke.compare_with_cpu("plain", (), spec, [a], [b])
    with open(b, "r+b") as f:
        f.seek(-2, os.SEEK_END)
        f.write(b"\x01\x02")
    with pytest.raises(chip_smoke.SmokeFailure, match="payload differs"):
        chip_smoke.compare_with_cpu("plain", (), spec, [a], [b])


def test_lj92_lossless_check(tmp_path):
    from mlvfs_tpu.format import synth
    from mlvfs_tpu.pipeline.config import ProcessingConfig
    from mlvfs_tpu.pipeline.convert import convert_clip

    src = str(tmp_path / "M01-0001.MLV")
    spec = synth.write_mlv(src, width=128, height=32, frames=2)
    lj92 = convert_clip(src, str(tmp_path / "lj92"), ProcessingConfig(compress="lj92"))
    plain = convert_clip(src, str(tmp_path / "plain"))
    assert "bit-exact" in chip_smoke.check_lj92_lossless("lj92", spec, lj92, plain)
    with pytest.raises(chip_smoke.SmokeFailure, match="does not decode"):
        chip_smoke.check_lj92_lossless("lj92", spec, lj92, plain[::-1])


def test_psnr():
    a = np.zeros((4, 4), np.uint16)
    assert chip_smoke.psnr_db(a, a) == float("inf")
    b = a.copy()
    b[0, 0] = 655  # mse = 655^2 / 16
    want = 10 * np.log10(65535.0**2 * 16 / 655.0**2)
    assert abs(chip_smoke.psnr_db(a, b) - want) < 1e-9


@pytest.mark.usefixtures("eight_devices")
def test_four_card_path_on_virtual_cpu_devices(tmp_path):
    """The --four phase (shards on four devices, DNGs equal to one device)
    on four of the suite's virtual CPU devices."""
    assert len(jax.devices()) >= 4
    chip_smoke.run_four_cards(SMALL, str(tmp_path), "cpu")
