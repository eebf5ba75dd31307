"""Test harness: force an 8-device virtual CPU mesh.

The tests run on the host CPU even where a GPU is present, and exercise
multi-device sharding on 8 virtual CPU devices. The GPU path is checked
by `chip_smoke.py` (`python chip_smoke.py`, `--four-cards` for the
4-card mesh). `import pytest` already pulls in jax via a plugin, so env
vars alone are too late — but backends initialize lazily, so
`jax.config.update` before the first `jax.devices()` call still wins.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
