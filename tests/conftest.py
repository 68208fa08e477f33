"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding paths are exercised without accelerators via
``xla_force_host_platform_device_count`` (see SURVEY.md §4). The suite runs
on the CPU unless ``JAX_PLATFORMS`` names another platform; tests marked
``chip`` need an NVIDIA GPU and skip elsewhere
(``JAX_PLATFORMS=cuda python -m pytest tests/ -m chip`` runs them on a card).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

from topk_rec_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache("jax_cpu")

import numpy as np
import pytest

from topk_rec_tpu.data.dataset import Interactions, synthetic_interactions


def pytest_configure(config):
    """Register markers and build the native runtime lib before collection.

    Native lib: built here so its golden tests
    never silently skip: the `needs_native` skipif in test_native.py is
    evaluated at import time, hence the build must happen here. Fails
    loudly when a C++ toolchain exists but the build breaks; the tests
    skip only when no compiler is installed."""
    import shutil
    import subprocess

    config.addinivalue_line(
        "markers",
        "slow: long-running end-to-end tests (deselect with -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "chip: needs an NVIDIA GPU; skips elsewhere (decided per test by "
        "the _chip_only fixture)",
    )
    if (
        shutil.which(os.environ.get("CXX", "g++")) is None
        or shutil.which("make") is None
    ):
        return  # no toolchain: the native tests skip themselves
    native_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "topk_rec_tpu",
        "native",
    )
    r = subprocess.run(
        ["make", "-C", native_dir], capture_output=True, text=True
    )
    if r.returncode != 0:
        raise pytest.UsageError(
            "native lib build failed (make -C topk_rec_tpu/native):\n"
            + r.stderr[-2000:]
        )


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip ``chip``-marked tests unless JAX's default device is a GPU.
    Decided here, per test, never at import or collection time."""
    if request.node.get_closest_marker("chip") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.fixture(scope="session")
def tiny_inter() -> Interactions:
    """Hand-written 4-user / 6-item fold used for exact-value tests."""
    #            items:  0  1  2  3  4  5
    # user 0 likes 0,2; browsed also 4 (disliked)
    # user 1 likes 1,3,5
    # user 2 likes 2
    # user 3 has no positives; browsed 0
    pos_u = np.array([0, 0, 1, 1, 1, 2], dtype=np.int32)
    pos_i = np.array([0, 2, 1, 3, 5, 2], dtype=np.int32)
    seen_u = np.array([0, 0, 0, 1, 1, 1, 2, 3], dtype=np.int32)
    seen_i = np.array([0, 2, 4, 1, 3, 5, 2, 0], dtype=np.int32)
    return Interactions(4, 6, pos_u, pos_i, seen_u, seen_i)


@pytest.fixture(scope="session")
def small_inter() -> Interactions:
    """Synthetic structured fold big enough for learning tests."""
    return synthetic_interactions(n_users=120, n_items=80, n_pos=1500, seed=7)
