"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set the environment before jax is imported anywhere. The device
path's on-card checks are `python chip_smoke.py`, not tests.
"""

import os
import pathlib

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden_dir() -> pathlib.Path:
    return GOLDEN
