"""Scaling-efficiency harness plumbing on the virtual 8-device CPU mesh.

The CPU numbers are meaningless as performance; what must hold is that the
harness runs every mesh size, produces rays/s + efficiency for forward and
inverse, and defines efficiency as (rate_d / rate_1) / d.
"""

import numpy as np

from brickmap_tpu import scene as scene_mod
from brickmap_tpu.app.scaling import _device_counts, run_scaling_benchmark
from brickmap_tpu.config import BrickmapConfig, GridConfig, RenderConfig


def test_device_counts():
    assert _device_counts(8) == [1, 2, 4, 8]
    assert _device_counts(6) == [1, 2, 4, 6]
    assert _device_counts(1) == [1]


def test_scaling_benchmark_runs_on_cpu_mesh(march_on_cpu):
    """Forward waves and sparse inverse steps, both through the march kernel
    (interpret mode), on every mesh size."""
    cfg = BrickmapConfig(
        grid=GridConfig(grid_size=128, grid_height=128),
        render=RenderConfig(width=32, height=16, max_bounces=1,
                            max_top_steps=64),
    )
    dense = np.zeros((128, 128, 128), bool)
    dense[16:48, 32:96, 32:96] = True
    sc = scene_mod.scene_from_dense(dense, cfg.grid)

    # Full [1, 2, 4, 8] ladder over the virtual mesh.
    out = run_scaling_benchmark(sc, cfg, 32, 16, device_counts=[1, 2, 4, 8],
                                waves=1, inverse_rays=256, k_segments=4,
                                verbose=False)
    assert out["device_counts"] == [1, 2, 4, 8]
    assert len(out["rows"]) == 4
    for row in out["rows"]:
        assert row["forward_rays_per_s"] > 0
        assert row["inverse_rays_per_s"] > 0
    r1 = out["rows"][0]
    assert r1["forward_efficiency_pct"] == 100.0
    assert r1["inverse_efficiency_pct"] == 100.0
    for d, row in zip([1, 2, 4, 8], out["rows"]):
        expect = round(100.0 * (row["forward_rays_per_s"]
                                / r1["forward_rays_per_s"]) / d, 1)
        assert row["forward_efficiency_pct"] == expect
    assert out["num_processes"] == 1
