"""Test configuration.

By default the tests run on the CPU with 8 virtual devices, so the
multi-device sharding logic (``parallel/``) is exercised without cards
and the ray-march kernel runs in Pallas' interpret mode.  On a machine
with a GPU, ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` runs
the tests marked ``gpu``, which compile the kernel for the card; elsewhere
they skip.  Must set env vars before the first ``import jax`` anywhere.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

from volumetric_renderer.utils.env import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests where JAX has no GPU (decided per test,
    never at import, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run JAX_PLATFORMS=cuda pytest -m gpu "
                    "on the card")
