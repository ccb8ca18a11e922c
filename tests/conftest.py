import os
import sys

# The tests run on the CPU backend, multi-device tests on a virtual
# 8-device CPU mesh; the GPU path is checked by chip_smoke.py.  Must be
# set before jax import.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_configure(config):
    import jax
    from jxl_coder import backend
    jax.config.update("jax_platforms", "cpu")
    # persistent XLA compile cache: VarDCT pipeline graphs compile once
    backend.use_compile_cache()

REFERENCE_ASSETS = "/root/reference/app/src/main/assets"


def asset(name: str) -> bytes:
    """Load a real-world corpus file from the (read-only) reference checkout.

    These are data files (test images), read in place — never copied into
    this repo.  Tests that need them skip when the reference isn't mounted.
    """
    path = os.path.join(REFERENCE_ASSETS, name)
    if not os.path.exists(path):
        pytest.skip(f"reference corpus not available: {name}")
    with open(path, "rb") as f:
        return f.read()


def all_assets():
    if not os.path.isdir(REFERENCE_ASSETS):
        return []
    return sorted(f for f in os.listdir(REFERENCE_ASSETS) if f.endswith(".jxl"))
