"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding correctness is validated on
XLA's host-platform virtual devices (SURVEY.md §4 "Multi-host without a cluster").
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Force the CPU: the suite checks results, and the card is for measurement.
# Set BRICKMAP_TEST_GPU=1 to opt in to the card (tests marked ``gpu`` run
# only there; see the ``gpu`` fixture below).
if not os.environ.get("BRICKMAP_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng(request):
    """Per-test deterministic rng.

    Seeded from the test's nodeid (stable hash) so each test's random data
    is independent of execution order — a session-scoped stream made every
    added/filtered test shift later tests' rays, which surfaced
    tolerance-marginal failures that only reproduced in specific orders."""
    import zlib

    seed = zlib.crc32(request.node.nodeid.encode()) & 0xFFFFFFFF
    return np.random.default_rng(seed)


@pytest.fixture()
def gpu():
    """For tests marked ``gpu``: skip unless JAX's default device is a GPU.

    Decided here, at run time, never while a module is imported."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with BRICKMAP_TEST_GPU=1 on the card)")
    return jax.devices()[0]


@pytest.fixture()
def march_on_cpu(monkeypatch):
    """Route the CPU branch of the traversal and recorder dispatch
    (``render.pathtrace._trace``, ``diff.sparse.record_segments``) to the
    march kernel in interpret mode, so end-to-end paths run the kernel here.

    Jitted stages cache their traces per static config, so the caches are
    cleared on the way in and out: no XLA trace serves a kernel test, and
    no kernel trace outlives it."""
    from functools import partial

    import jax

    from brickmap_tpu.diff import sparse
    from brickmap_tpu.pallas.march import (record_segments_kernel,
                                           trace_rays_kernel)
    from brickmap_tpu.render import pathtrace

    monkeypatch.setattr(pathtrace, "trace_rays", partial(
        trace_rays_kernel, block=32, interpret=True))
    monkeypatch.setattr(sparse, "record_segments_xla", partial(
        record_segments_kernel, block=32, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def session_rng():
    """Shared stream for session-scoped fixtures (world builders)."""
    return np.random.default_rng(1234)
