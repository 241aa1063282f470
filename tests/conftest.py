import os
import pathlib
import sys

# The suite runs on the CPU (multi-device tests on a virtual CPU mesh);
# tests marked `gpu` run only where JAX finds a GPU (see README).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from abpoa_tpu.jaxcache import enable_compile_cache  # noqa: E402

enable_compile_cache()

GOLDEN = REPO / "tests" / "golden"
GOLDEN_SAN = REPO / "tests" / "golden_sanitized"
DATA = REPO / "tests" / "data"


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is a GPU (decided here, at run time, so
    every test worker collects the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (JAX backend is {jax.default_backend()!r})")
