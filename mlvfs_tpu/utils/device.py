"""What a measurement runs on: the accelerator JAX found, and the card's
name and power limit as nvidia-smi reports them.

Measurement paths (bench.py, chip_smoke.py) call ``require_accelerator``
first: a run that finds no accelerator fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess

import jax


class NoAcceleratorError(RuntimeError):
    pass


def require_accelerator() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices; raises
    NoAcceleratorError when JAX found only the CPU."""
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        raise NoAcceleratorError("JAX found no accelerator (platform 'cpu')")
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """One line per card: ``name, power.limit`` from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()
