"""Replay a real EuRoC ground-truth trajectory through the full pipeline and
score ATE against the same ground-truth file (the reference's dataset-run
validation, re-created without image data — see utils/gt_replay.py).

    python scripts/run_gt_replay.py --seq MH01 --sensor mono \
        [--render features|images] [--stride 1] [--max-frames 0]

Prints one JSON line with ATE RMSE (m), tracked fps, tracked ratio.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="MH01")
    ap.add_argument("--sensor",
                    choices=["mono", "imu-mono", "stereo", "imu-stereo",
                             "rgbd", "imu-rgbd"],
                    default="mono")
    ap.add_argument("--render", choices=["features", "images"],
                    default="features")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--start-frame", type=int, default=0)
    ap.add_argument("--n-features", type=int, default=1024)
    ap.add_argument("--async-mapping", action="store_true",
                    help="overlap mapping with tracking (real-time mode; "
                         "the mapper can lag the 20 Hz timestamps and "
                         "degrade accuracy — default is the offline "
                         "synchronous mode)")
    ap.add_argument("--no-loop", action="store_true",
                    help="disable loop closing / merging (isolation runs)")
    ap.add_argument("--out", default=None, help="TUM trajectory output path")
    args = ap.parse_args(argv)

    from orb_slam3_comments_ghr_tpu.utils.cache import setup_compile_cache
    setup_compile_cache(min_compile_secs=1.0)
    import jax.numpy as jnp

    from orb_slam3_comments_ghr_tpu.ops import cameras
    from orb_slam3_comments_ghr_tpu.system import SLAM
    from orb_slam3_comments_ghr_tpu.utils import evaluation, gt_replay, synthetic
    from orb_slam3_comments_ghr_tpu.utils.config import (
        SlamConfig, MONOCULAR, STEREO, IMU_MONOCULAR, IMU_STEREO,
        RGBD, IMU_RGBD,
    )
    from orb_slam3_comments_ghr_tpu.optim import imu as imu_mod

    times, R_cw, t_cw, p_wc, q_wc = gt_replay.load_euroc_gt(args.seq)
    n = len(times)
    if args.max_frames:
        n = min(n, args.max_frames)
    idx = list(range(args.start_frame, n, args.stride))

    cam = cameras.euroc_cam0()
    sensor = {"mono": MONOCULAR, "imu-mono": IMU_MONOCULAR,
              "stereo": STEREO, "imu-stereo": IMU_STEREO,
              "rgbd": RGBD, "imu-rgbd": IMU_RGBD}[args.sensor]
    stereo = sensor in (STEREO, IMU_STEREO)
    rgbd = sensor in (RGBD, IMU_RGBD)
    if (stereo or rgbd) and cam.bf <= 0:
        from dataclasses import replace as _replace
        cam = _replace(cam, bf=float(cam.fx) * 0.11)  # EuRoC ~11 cm baseline
    cfg = SlamConfig(
        sensor=sensor, n_features=args.n_features,
        min_init_matches=max(40, args.n_features // 10),
        max_frames_between_kf=10,
        async_mapping=args.async_mapping,
        enable_loop_closing=not args.no_loop,
    )
    imu_rows = None
    imu_calib = None
    if cfg.is_inertial:
        imu_hz = 200.0
        imu_rows = gt_replay.synthesize_imu(times[:n], p_wc[:n], q_wc[:n],
                                            imu_hz=imu_hz)
        # EuRoC continuous noise DENSITIES converted to per-sample sigmas
        # exactly as the reference's Settings does (Tracking.cc:680-681:
        # noise * sqrt(freq), walk / sqrt(freq)). Passing raw densities as
        # discrete sigmas makes the inertial information ~200x too tight and
        # whole-chain inertial BA then overpowers the visual geometry.
        sf = imu_hz ** 0.5
        imu_calib = imu_mod.ImuCalib(
            Rbc=jnp.eye(3), tbc=jnp.zeros(3),
            noise_g=1.7e-4 * sf, noise_a=2e-3 * sf,
            walk_g=2e-5 / sf, walk_a=3e-3 / sf,
        )
    slam = SLAM(cam, cfg, imu_calib=imu_calib)

    if args.render == "features":
        # dense enough that ANY hover view clears the 500-keypoint stereo
        # init gate (sparser worlds starve views facing the hall's far end)
        world = gt_replay.make_hall_world(11, p_wc[:n], n_points=48000)
    else:
        scene = gt_replay.make_room_scene(11, p_wc[:n])

    n_tracked = 0
    t_last_imu = -1.0
    frame_times = []
    t0_wall = time.perf_counter()
    for j, i in enumerate(idx):
        ts = float(times[i])
        if imu_rows is not None:
            chunk = imu_rows[(imu_rows[:, 0] > t_last_imu)
                             & (imu_rows[:, 0] <= ts)]
            if len(chunk):
                slam.feed_imu(chunk)
            t_last_imu = ts
        t_f = time.perf_counter()
        if args.render == "features":
            feats, _ = synthetic.render_features(
                world, cam, R_cw[i], t_cw[i], n_feat=args.n_features,
                seed=1000 + i, stereo=stereo or rgbd)
            pose = slam.track_features(feats, ts)
        elif rgbd:
            # exact per-pixel depth from the room-box geometry (the ideal
            # RGB-D sensor; reference driver: ros_rgbd_inertial.cc)
            img, depth = gt_replay.render_room(
                scene, cam, R_cw[i], t_cw[i], return_depth=True)
            pose = slam.track_rgbd(img, depth, ts)
        else:
            img = gt_replay.render_room(scene, cam, R_cw[i], t_cw[i])
            if stereo:
                # right camera: center shifted by +baseline along the left
                # camera's x axis => t_r = t_l - [b,0,0] (rectified pair)
                b = float(cam.bf) / float(cam.fx)
                t_r = t_cw[i] - np.array([b, 0.0, 0.0], t_cw.dtype)
                img_r = gt_replay.render_room(scene, cam, R_cw[i], t_r)
                pose = slam.track_stereo(jnp.asarray(img), jnp.asarray(img_r),
                                         ts)
            else:
                pose = slam.track_monocular(jnp.asarray(img), ts)
        frame_times.append(time.perf_counter() - t_f)
        if pose is not None:
            n_tracked += 1
        if j % 200 == 0:
            print(f"[{j}/{len(idx)}] tracked={n_tracked} "
                  f"kf={slam.n_keyframes()} mp={slam.n_map_points()} "
                  f"maps={slam.map.n_maps}", file=sys.stderr)
    wall = time.perf_counter() - t0_wall

    if hasattr(slam, "wait_idle"):
        slam.wait_idle()
    est = slam.trajectory()
    gt = gt_replay.gt_as_tum(times[:n], R_cw[:n], t_cw[:n])
    ate = evaluation.ate_rmse(est, gt, with_scale=True)
    ate_noscale = evaluation.ate_rmse(est, gt, with_scale=False)
    # dominant-map ATE: frames whose reference keyframe lives in the largest
    # map (sub-map fragments have unrelated world frames; mixing them into
    # one Horn alignment is meaningless)
    from collections import Counter
    recs = [r for r in slam.tracker.records if not r.lost and r.ref_kf >= 0]
    mid_of = lambda r: int(slam.map.kf_map_id[r.ref_kf])
    counts = Counter(mid_of(r) for r in recs)
    ate_main = float("nan")
    main_frac = 0.0
    if counts:
        main_map, n_main = counts.most_common(1)[0]
        main_ts = {r.timestamp for r in recs if mid_of(r) == main_map}
        est_main = [e for e in est if e[0] in main_ts]
        ate_main = evaluation.ate_rmse(est_main, gt, with_scale=False)
        main_frac = n_main / max(len(recs), 1)
    med = float(np.median(frame_times[10:])) if len(frame_times) > 20 else 0.0
    if args.out:
        slam.save_trajectory_tum(args.out)
    print(json.dumps({
        "seq": args.seq, "sensor": args.sensor, "render": args.render,
        "frames": len(idx), "tracked": n_tracked,
        "tracked_ratio": round(n_tracked / max(len(idx), 1), 3),
        "ate_rmse_m": round(float(ate), 4),
        "ate_rmse_noscale_m": round(float(ate_noscale), 4),
        "ate_main_map_noscale_m": round(float(ate_main), 4),
        "main_map_frame_frac": round(main_frac, 3),
        "fps_median": round(1.0 / max(med, 1e-9), 2),
        "wall_s": round(wall, 1),
        "keyframes": slam.n_keyframes(), "map_points": slam.n_map_points(),
        "maps": slam.map.n_maps, "loops": slam.loopcloser.n_loops,
        "kf_removed": slam.map.n_kf_removed,
        "map_resets": getattr(slam, "n_map_resets", 0),
        "lost_resets": getattr(slam.tracker, "n_lost_resets", 0),
        "submap_spawns": getattr(slam.tracker, "n_submap_spawns", 0),
        "merges": slam.loopcloser.n_merges,
    }))


if __name__ == "__main__":
    main()
