"""Gate the entry points in __graft_entry__.py."""

import os
import sys

import jax
import pytest


def _load_entry():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    return g


def test_dryrun_multichip_runs_inline():
    # runs in-process on the test suite's 8-device virtual CPU mesh
    g = _load_entry()
    g.dryrun_multichip(8)


def test_dryrun_multichip_rejects_oversized_mesh():
    g = _load_entry()
    with pytest.raises(RuntimeError, match="xla_force_host_platform_device_count"):
        g.dryrun_multichip(len(jax.devices("cpu")) + 1)
