"""Plumbing that picks implementations and settings, checked on the CPU:
which traversal and recorder a program compiles to on each platform, the
compile-cache rule, and that the chip smoke test refuses to run here."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRITON_CALL = "__gpu$xla.gpu.triton"
GRID = GridConfig(grid_size=128, grid_height=128)


@pytest.fixture(scope="module")
def flat_scene():
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    return jax.tree.map(jnp.asarray, scene_mod.scene_from_dense(dense, GRID))


def _rays(n=256):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (np.array([64.0, 64.0, 40.0]) - d * 100).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def _lowered_text(fn, platform, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,kernel", [("cuda", True), ("cpu", False)])
def test_trace_picks_kernel_by_platform(flat_scene, platform, kernel):
    """``_trace`` compiles to the Triton kernel for a GPU (a compiled Triton
    call, never the interpreter) and to the XLA traversal for the CPU."""
    from brickmap_tpu.render import pathtrace

    cfg = BrickmapConfig(grid=GRID, render=RenderConfig(max_top_steps=64))
    o, d = _rays()
    text = _lowered_text(
        lambda o, d, sc: pathtrace._trace(o, d, sc, jnp.zeros(3, jnp.int32),
                                          cfg), platform, o, d, flat_scene)
    assert (TRITON_CALL in text) == kernel


def test_trace_xla_override_on_gpu(flat_scene):
    """``traversal="xla"`` keeps the XLA traversal even on a GPU."""
    from brickmap_tpu.render import pathtrace

    cfg = BrickmapConfig(grid=GRID, render=RenderConfig(max_top_steps=64,
                                                        traversal="xla"))
    o, d = _rays()
    text = _lowered_text(
        lambda o, d, sc: pathtrace._trace(o, d, sc, jnp.zeros(3, jnp.int32),
                                          cfg), "cuda", o, d, flat_scene)
    assert TRITON_CALL not in text


@pytest.mark.parametrize("platform,kernel", [("cuda", True), ("cpu", False)])
def test_record_picks_kernel_by_platform(flat_scene, platform, kernel):
    from brickmap_tpu.diff.sparse import record_segments

    o, d = _rays()
    text = _lowered_text(
        lambda o, d, sc: record_segments(o, d, sc, GRID, k_segments=4),
        platform, o, d, flat_scene)
    assert (TRITON_CALL in text) == kernel


def test_trace_source_never_interprets():
    """Interpret mode is requested only by tests: no library module passes
    ``interpret=True``."""
    pkg = os.path.join(ROOT, "brickmap_tpu")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "interpret=True" not in fh.read(), f


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """Where JAX_COMPILATION_CACHE_DIR is set, nothing is set in code."""
    from brickmap_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    """Otherwise the cache lives at one fixed, git-ignored path inside the
    checkout."""
    from brickmap_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        with open(os.path.join(ROOT, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu():
    """On the CPU chip_smoke.py exits nonzero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr
