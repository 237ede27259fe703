"""Profiling hooks: jax.profiler traces + named annotations.

The reference's profiling is an ImGui frame-time panel plus coarse
``std::cout`` phase timing (SURVEY.md §5 A1); the equivalents here are
jax.profiler traces viewable in XProf/TensorBoard and
``TraceAnnotation``-scoped host phases — the trace shows device activity,
the JSONL metrics (utils/metrics.py) show wall clock.
"""

from __future__ import annotations

import contextlib

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a jax.profiler trace into ``logdir`` (no-op when None).

    View with ``tensorboard --logdir <dir>`` or XProf.
    """
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named host-side region (shows as a TraceMe in the profile)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
