"""Benchmark: end-to-end SLAM throughput on one GPU.

Two sections, each run for a fixed number of passes through the normal
pipelined entry points with async mapping on:

  * mono: a rendered 752x480 EuRoC-cam0 sequence (300 frames, 1024 ORB
    features, 8 levels) through `SLAM.track_monocular_pipelined`;
  * stereo_inertial: 150 rendered stereo pairs plus 200 Hz IMU samples
    through `SLAM.track_stereo_pipelined`.

Per pass the frame time is the host wall time of one entry-point call,
median over the frames after warm-up. Each section reports the median of
the pass medians and their spread (min, max), the ATE of the last pass, and
the amortized device time of the two per-frame programs. The reference runs
real-time at the 20 Hz EuRoC camera rate on a desktop CPU, so 20 frames/s is
the baseline.

The script fails when JAX finds no GPU; it never falls back to the CPU.
Prints the card's name and power limit, then ONE JSON line.
"""

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_FPS = 20.0
N_MONO_FRAMES = 300
N_SI_FRAMES = 150
MONO_PASSES = 5
SI_PASSES = 3
MONO_WARMUP = 12
SI_WARMUP = 45   # init + the three-stage IMU initialization window


def require_gpu(jax):
    """Return jax.devices() if the default backend is a GPU; exit otherwise."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"no GPU found: JAX's default device is {devices[0]} "
                 f"(platform {devices[0].platform!r}); this runs only on a GPU")
    return devices


def card_name_and_power() -> str:
    """`name, power.limit` of the first card, read by nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def bench_config(inertial: bool = False):
    from orb_slam3_comments_ghr_tpu.utils.config import SlamConfig, IMU_STEREO

    kw = {"sensor": IMU_STEREO} if inertial else {}
    return SlamConfig(
        n_features=1024,
        local_points_cap=4096,
        local_ba_points=2048,
        max_frames_between_kf=10,
        min_init_matches=60,
        async_mapping=True,   # pipeline parallelism: BA overlaps tracking
        **kw,
    )


def stereo_camera():
    """EuRoC cam0 with an 11 cm stereo baseline."""
    from dataclasses import replace
    from orb_slam3_comments_ghr_tpu.ops import cameras

    cam = cameras.euroc_cam0()
    return replace(cam, bf=float(cam.fx) * 0.11) if cam.bf <= 0 else cam


def imu_calib():
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.optim import imu as imu_mod

    return imu_mod.ImuCalib(
        Rbc=jnp.eye(3), tbc=jnp.zeros(3),
        noise_g=1e-4, noise_a=1e-3, walk_g=1e-6, walk_a=1e-5,
    )


def mono_images(cam, n_frames):
    """Rendered uint8 frames along the circular bench trajectory (host-side,
    excluded from timing)."""
    from orb_slam3_comments_ghr_tpu.utils import synthetic

    scene = synthetic.make_textured_scene(7)
    poses = synthetic.circular_trajectory(n_frames)
    images = [
        np.clip(np.round(synthetic.render_image(scene, cam, R, t)), 0, 255)
        .astype(np.uint8)
        for (R, t) in poses
    ]
    return images, poses


def si_images(cam, n_frames):
    """Rendered L+R pairs along a smooth arc with analytically consistent
    IMU samples (host-side, excluded from timing)."""
    from orb_slam3_comments_ghr_tpu.utils import synthetic

    scene = synthetic.make_textured_scene(7)
    poses, imu_rows, times = synthetic.vi_sequence(n_frames)
    b = float(cam.bf) / float(cam.fx)
    imgs = []
    for (R, t) in poses:
        il = np.clip(np.round(synthetic.render_image(scene, cam, R, t)),
                     0, 255).astype(np.uint8)
        # rectified right camera: centre shifted +b along the left x axis
        t_r = np.asarray(t) - np.array([b, 0.0, 0.0], np.float32)
        ir = np.clip(np.round(synthetic.render_image(scene, cam, R, t_r)),
                     0, 255).astype(np.uint8)
        imgs.append((il, ir))
    return imgs, imu_rows, times, poses


def mono_pass(cam, cfg, images, warmup=MONO_WARMUP):
    """One full-pipeline monocular pass, frames back to back. Returns
    (slam, frame_times_s)."""
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.system import SLAM

    slam = SLAM(cam, cfg)
    frame_times = []
    for i, img in enumerate(images):
        t0 = time.perf_counter()
        slam.track_monocular_pipelined(jnp.asarray(img), i * 0.05)
        if i >= warmup:
            frame_times.append(time.perf_counter() - t0)
    slam.flush_pipeline()
    slam.wait_idle()
    return slam, frame_times


def si_pass(cam, cfg, calib, imgs, imu_rows, times, warmup=SI_WARMUP):
    """One stereo-inertial pass through the pipelined stereo path. Returns
    (slam, frame_times_s)."""
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.system import SLAM

    slam = SLAM(cam, cfg, imu_calib=calib)
    frame_times = []
    t_last = -1.0
    for i, (il, ir) in enumerate(imgs):
        ts = float(times[i])
        chunk = imu_rows[(imu_rows[:, 0] > t_last) & (imu_rows[:, 0] <= ts)]
        t_last = ts
        t0 = time.perf_counter()
        slam.track_stereo_pipelined(
            jnp.asarray(il), jnp.asarray(ir), ts,
            imu_samples=chunk if len(chunk) else None)
        if i >= warmup:
            frame_times.append(time.perf_counter() - t0)
    slam.flush_pipeline()
    slam.wait_idle()
    return slam, frame_times


def device_ms_per_frame(jax, extract, track, chain=30):
    """Amortized per-frame device time of the pipelined tracker's two
    per-frame programs, dispatched back to back with one final sync.
    `extract()` returns features; `track(feats)` returns the track result."""
    jax.block_until_ready(track(extract()))
    t0 = time.perf_counter()
    out = None
    for _ in range(chain):
        out = track(extract())
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / chain * 1e3


def _summary(pass_medians_s):
    fps = [1.0 / m for m in pass_medians_s]
    return {
        "fps_median": float(np.median(fps)),
        "fps_pass_medians": fps,
        "fps_spread": [min(fps), max(fps)],
    }


def main():
    import jax

    devices = require_gpu(jax)
    card = card_name_and_power()
    from orb_slam3_comments_ghr_tpu.utils.cache import setup_compile_cache

    setup_compile_cache(min_compile_secs=1.0)
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.ops import cameras
    from orb_slam3_comments_ghr_tpu.pipeline import programs
    from orb_slam3_comments_ghr_tpu.utils import synthetic, evaluation
    from __graft_entry__ import _synth_track_inputs

    print(f"card: {card}", flush=True)
    cam = cameras.euroc_cam0()
    cfg = bench_config()
    images, poses = mono_images(cam, N_MONO_FRAMES)
    _, _, lp, R0, t0 = _synth_track_inputs(
        n_feat=cfg.n_features, n_pts=cfg.local_points_cap)
    img1 = jnp.asarray(images[1])

    meds, dev_ms = [], []
    slam = None
    for _ in range(MONO_PASSES):
        dev_ms.append(device_ms_per_frame(
            jax,
            lambda: programs.extract_only(cam, img1, n_features=cfg.n_features),
            lambda f: programs.track_only(cam, f, lp, R0, t0)))
        if slam is not None:
            slam.shutdown()
        slam, ft = mono_pass(cam, cfg, images)
        meds.append(float(np.median(ft)))
    est = slam.trajectory()
    mono = _summary(meds) | {
        "ate_m": evaluation.ate_rmse(
            est, synthetic.gt_trajectory(poses), with_scale=True),
        "tracked_frames": len(est),
        "total_frames": N_MONO_FRAMES,
        "keyframes": slam.n_keyframes(),
        "map_points": slam.n_map_points(),
        "worker_errors": slam.worker_errors,
        "device_ms_per_frame": float(np.median(dev_ms)),
    }
    slam.shutdown()

    cam_b = stereo_camera()
    cfg_si = bench_config(inertial=True)
    calib = imu_calib()
    si_imgs, si_rows, si_times, si_poses = si_images(cam_b, N_SI_FRAMES)
    il1, ir1 = jnp.asarray(si_imgs[1][0]), jnp.asarray(si_imgs[1][1])
    meds, dev_ms = [], []
    slam = None
    for _ in range(SI_PASSES):
        dev_ms.append(device_ms_per_frame(
            jax,
            lambda: programs.extract_stereo_only(
                cam_b, il1, ir1, n_features=cfg_si.n_features),
            lambda f: programs.track_only(cam_b, f, lp, R0, t0)))
        if slam is not None:
            slam.shutdown()
        slam, ft = si_pass(cam_b, cfg_si, calib, si_imgs, si_rows, si_times)
        meds.append(float(np.median(ft)))
    est = slam.trajectory()
    si = _summary(meds) | {
        # stereo is metric: no scale fit in the ATE
        "ate_metric_m": evaluation.ate_rmse(
            est, synthetic.gt_trajectory(si_poses), with_scale=False),
        "tracked_frames": len(est),
        "total_frames": N_SI_FRAMES,
        "imu_initialized": bool(
            slam.map.map_imu_init.get(slam.map.active_map, False)),
        "worker_errors": slam.worker_errors,
        "device_ms_per_frame": float(np.median(dev_ms)),
    }
    slam.shutdown()

    print(json.dumps({
        "metric": "mono_slam_tracked_fps",
        "value": mono["fps_median"],
        "unit": "frames/s",
        "vs_baseline": mono["fps_median"] / BASELINE_FPS,
        "extra": {
            "device": {"platform": devices[0].platform,
                       "kind": devices[0].device_kind,
                       "count": len(devices)},
            "card": card,
            "mono": mono,
            "stereo_inertial": si,
        },
    }))


if __name__ == "__main__":
    main()
