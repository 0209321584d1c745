"""chip_smoke.py: its comparison helpers, its refusal to run without a GPU,
the 4-way distributed-BA comparison on virtual CPU devices, and (on a GPU
machine only) the front-end and tracking agreement phases."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from orb_slam3_comments_ghr_tpu.frontend.types import Features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _features(xy, level, desc, angle=None):
    n = len(xy)
    return Features(
        xy=np.asarray(xy, np.float32), level=np.asarray(level, np.int32),
        angle=np.zeros(n, np.float32) if angle is None else np.asarray(angle),
        response=np.ones(n, np.float32), desc=np.asarray(desc, np.uint32),
        valid=np.ones(n, bool), u_right=-np.ones(n, np.float32),
        depth=-np.ones(n, np.float32),
    )


class TestComparisonHelpers:
    def test_colocation_needs_same_xy_and_level(self):
        a = _features([[1, 1], [5, 5], [9, 9], [3, 3]], [0, 1, 2, 0],
                      np.zeros((4, 8)))
        b = _features([[5, 5], [1, 1], [9, 9], [3.5, 3]], [1, 0, 1, 0],
                      np.zeros((4, 8)))
        i, j, n = cs.colocated_pairs(a.xy, a.level, a.valid,
                                     b.xy, b.level, b.valid)
        assert n == 4
        assert list(i) == [0, 1] and list(j) == [1, 0]

    def test_hamming_bits(self):
        a = np.zeros((3, 8), np.uint32)
        b = np.zeros((3, 8), np.uint32)
        b[1, 0] = 0b1011
        b[2] = 0xFFFFFFFF
        assert list(cs.hamming_bits(a, b)) == [0, 3, 256]

    def test_features_agreement(self):
        rng = np.random.default_rng(0)
        desc = rng.integers(0, 2**32, (10, 8), dtype=np.uint32)
        xy = rng.random((10, 2)) * 100
        a = _features(xy, np.arange(10) % 3, desc, angle=np.full(10, 3.1))
        flipped = desc.copy()
        flipped[:, 0] ^= np.uint32(1)        # one bit per descriptor
        moved = xy.copy()
        moved[:2] += 2.0                     # two keypoints moved away
        b = _features(moved, np.arange(10) % 3, flipped,
                      angle=np.full(10, -3.1))
        r = cs.features_agreement(a, b)
        assert r["keypoints"] == 10 and r["keypoints_ref"] == 10
        assert r["colocated"] == pytest.approx(0.8)
        assert r["mean_hamming"] == pytest.approx(1.0)
        # angles wrap: 3.1 vs -3.1 differ by 2*pi - 6.2
        assert r["max_angle_diff"] == pytest.approx(2 * np.pi - 6.2, abs=1e-6)

    def test_pose_agreement(self):
        th = 2e-4
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        r = cs.pose_agreement(R, [0, 0, 1e-3], np.eye(3), [0, 0, 0])
        assert r["rot_rad"] == pytest.approx(th, rel=1e-6)
        assert r["trans_m"] == pytest.approx(1e-3)
        assert cs.relative_diff(1.001, 1.0) == pytest.approx(1e-3)


class TestRefusesWithoutGpu:
    @pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
    def test_exits_nonzero_naming_the_gpu(self, script):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert "no GPU found" in r.stderr
        assert '"ok"' not in r.stdout and "fps" not in r.stdout


class TestDistributedBAComparison:
    def test_four_way_matches_one_device(self):
        devices = jax.devices()[:4]
        rep, sharded = cs.dba_agreement(jax, devices, n_points=2048,
                                        n_kfs=16, iters=4)
        assert rep["cost_rel"] <= cs.DBA_COST_REL
        assert rep["max_center_diff_m"] < 1e-3
        assert sharded.p.sharding.device_set == set(devices)
        assert len(rep["result_device_set"]) == 4


@pytest.mark.gpu
class TestOnGpu:
    def test_frontend_matches_cpu(self, gpu):
        cs.phase_frontend(jax, gpu.device_kind)

    def test_track_matches_cpu(self, gpu):
        cs.phase_track(jax, gpu.device_kind)
