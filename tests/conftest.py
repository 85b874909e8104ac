"""Test configuration.

Tests run on a virtual 8-device CPU mesh, so they need no accelerator and
exercise the multi-device sharding paths (SURVEY.md section 4:
single-host multi-device simulation).  The platform is pinned through
jax.config before the backend initializes (first device use).

Tests marked ``chip`` need a GPU; the ``gpu`` fixture skips them here.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAXJPEG_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run with JAXJPEG_TEST_PLATFORM=gpu on the card)")
    return devices[0]
