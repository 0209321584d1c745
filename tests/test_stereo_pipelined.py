"""Deep-pipelined stereo(-inertial) tracking: the stereo twin of the
monocular pipeline (system.track_stereo_pipelined). The reference's flagship
driver is stereo-inertial (ros_stereo_inertial.cc); the deep pipeline
overlaps its device work with the host's map bookkeeping."""

import numpy as np
import jax.numpy as jnp
import pytest

from orb_slam3_comments_ghr_tpu.ops import cameras
from orb_slam3_comments_ghr_tpu.system import SLAM
from orb_slam3_comments_ghr_tpu.utils import synthetic, evaluation
from orb_slam3_comments_ghr_tpu.utils.config import SlamConfig, IMU_STEREO
from orb_slam3_comments_ghr_tpu.optim import imu as imu_mod


class TestStereoPipelined:
    def test_stereo_inertial_pipelined_images(self):
        """Rendered L+R images + consistent IMU through the deep pipeline:
        must initialize the IMU, track, and stay metric (no scale fit)."""
        from dataclasses import replace

        cam = cameras.euroc_cam0()
        if cam.bf <= 0:
            cam = replace(cam, bf=float(cam.fx) * 0.11)
        scene = synthetic.make_textured_scene(7)
        n_frames = 60
        poses, imu_rows, times = synthetic.vi_sequence(n_frames)
        b = float(cam.bf) / float(cam.fx)
        cfg = SlamConfig(
            sensor=IMU_STEREO, n_features=768, local_points_cap=2048,
            local_ba_points=2048, max_frames_between_kf=5,
            enable_loop_closing=False,
        )
        calib = imu_mod.ImuCalib(
            Rbc=jnp.eye(3), tbc=jnp.zeros(3),
            noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5,
        )
        slam = SLAM(cam, cfg, imu_calib=calib)
        t_last = -1.0
        for i, (R, t) in enumerate(poses):
            ts = float(times[i])
            chunk = imu_rows[(imu_rows[:, 0] > t_last) & (imu_rows[:, 0] <= ts)]
            t_last = ts
            il = synthetic.render_image(scene, cam, R, t)
            t_r = np.asarray(t) - np.array([b, 0.0, 0.0], np.float32)
            ir = synthetic.render_image(scene, cam, R, t_r)
            slam.track_stereo_pipelined(
                jnp.asarray(il), jnp.asarray(ir), ts,
                imu_samples=chunk if len(chunk) else None)
        slam.flush_pipeline()
        est = slam.trajectory()
        assert slam.map.map_imu_init.get(slam.map.active_map, False), \
            "IMU never initialized through the pipelined stereo path"
        assert len(est) > 45, len(est)
        gt = [
            (times[i], np.vstack([
                np.hstack([poses[i][0], poses[i][1][:, None]]), [0, 0, 0, 1]
            ]).astype(np.float32))
            for i in range(n_frames)
        ]
        rmse = evaluation.ate_rmse(est, gt, with_scale=False)  # metric!
        assert rmse < 0.15, rmse
