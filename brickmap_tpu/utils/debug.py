"""Debug modes — this build's sanitizers (SURVEY.md §5).

The reference has no race detection or sanitizers (atomics + a frame-end
device sync are its whole concurrency story, voxel.cuh:229-238,
kernel.cu:431).  XLA is data-race-free by construction; what remains useful:

* NaN trapping (``jax.debug_nans``) — the analog of compute-sanitizer checks;
* deterministic re-runs (counter-based RNG makes every wave replayable from
  its key).
"""

from __future__ import annotations

from contextlib import contextmanager

__all__ = ["debug_nans", "enable_x64_guard"]


@contextmanager
def debug_nans(enable: bool = True):
    """Trap NaNs produced by any jitted computation inside the context."""
    import jax

    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


@contextmanager
def enable_x64_guard():
    """Run a block in x64 to diagnose float32 precision issues."""
    import jax

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)
