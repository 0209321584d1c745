"""Public SLAM system facade.

Mirror of ORB_SLAM3::System (reference: include/System.h:104-195): construct
with a camera + config, feed frames via track_monocular/track_stereo/
track_rgbd, query state, export trajectories. The reference's four pthreads
become: tracking inline (per frame), local mapping dispatched per keyframe,
loop closing per keyframe (pipeline.loopcloser) — all issuing jitted device
programs; see SURVEY.md §2.3 P1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp

from . import frontend
from .map.state import MapState, MapConfig
from .ops import cameras, lie
from .pipeline.tracker import Tracker, STATE_NAMES
from .pipeline.mapper import LocalMapper
from .utils.config import SlamConfig


class SLAM:
    def __init__(self, cam: cameras.Camera, cfg: Optional[SlamConfig] = None,
                 imu_calib=None):
        self.cam = cam
        # fisheye: extraction runs on raw images, geometry on undistorted
        # keypoints under the virtual pinhole (Frame::UndistortKeyPoints)
        self.geom_cam = cameras.pinhole_equivalent(cam)
        self.cfg = cfg or SlamConfig()
        mc = MapConfig(
            max_kf=self.cfg.max_kf,
            max_mp=self.cfg.max_mp,
            n_feat=self.cfg.n_features,
            obs_cap=self.cfg.obs_cap,
            scale_factor=self.cfg.scale_factor,
            n_levels=self.cfg.n_levels,
        )
        self.map = MapState(mc)
        import os
        from .retrieval.vocabulary import Vocabulary
        from .retrieval.database import KeyFrameDatabase
        voc_path = self.cfg.voc_path or os.path.join(
            os.path.dirname(__file__), "retrieval", "default_voc.npz")
        self.voc = Vocabulary.load(voc_path) if os.path.exists(voc_path) else Vocabulary.random()
        self.kfdb = KeyFrameDatabase(self.voc, self.cfg.max_kf)
        self.imu = None
        if self.cfg.is_inertial:
            from .optim import imu as imu_mod
            from .pipeline.imu_frontend import ImuFrontend
            self.imu = ImuFrontend(imu_calib or imu_mod.default_calib())
        self.tracker = Tracker(self.geom_cam, self.cfg, self.map, kfdb=self.kfdb,
                               imu=self.imu)
        self.mapper = LocalMapper(self.geom_cam, self.cfg, self.map, kfdb=self.kfdb)
        self.mapper.imu = self.imu
        self.mapper.kf_preint = self.tracker.kf_preint
        from .pipeline.loopcloser import LoopCloser
        self.loopcloser = LoopCloser(self.geom_cam, self.cfg, self.map,
                                     self.kfdb, self.mapper)
        self._empty_lp = None
        self._pipe: list[dict] = []  # in-flight frames (deep pipeline)
        self._map_queue = None
        self._map_worker = None
        self.worker_device = None  # set below for async mapping
        self.worker_errors = 0  # exceptions swallowed by the mapping worker
        if self.cfg.async_mapping:
            import queue as _q
            import threading
            # unbounded, like the reference's mlNewKeyFrames list: tracking
            # must NEVER block on mapping (LocalMapping.cc:378). Backpressure
            # is the KeyframesInQueue probe inside NeedNewKeyFrame
            # (Tracking.cc:3904) — when the mapper falls behind (e.g. while a
            # background GBA holds the device), new keyframes simply are not
            # created, the reference's SetAcceptKeyFrames semantics (P5).
            self._map_queue = _q.Queue()
            self.worker_device = self._worker_device()
            # share_stream (bite-wise BA) only matters when the mapper COULD
            # contend with tracking on the same device stream
            self.mapper.share_stream = self.worker_device is None
            self.mapper.queue_probe = self._map_queue.qsize  # mbAbortBA probe
            self.loopcloser.worker_device = self.worker_device
            self.tracker.queue_probe = self._map_queue.qsize
            self._map_worker = threading.Thread(
                target=self._mapping_worker, daemon=True
            )
            self._map_worker.start()

    # --------------------------------------------------------------- per-frame
    def feed_imu(self, samples) -> None:
        """samples: (M, 7) rows [t, ax, ay, az, wx, wy, wz]
        (System::TrackMonocular's vImuMeas argument / GrabImuData)."""
        if self.imu is None:
            raise RuntimeError("feed_imu requires an IMU_* sensor config")
        self.imu.feed(samples)

    def _dummy_local_points(self):
        """Empty local-point view so the fused program is the ONLY extractor
        compile (init/reloc frames ignore its track result)."""
        if self._empty_lp is None:
            from .pipeline import programs
            L = self.cfg.local_points_cap
            self._empty_lp = programs.LocalPoints(
                pos=jnp.zeros((L, 3)), desc=jnp.zeros((L, 8), jnp.uint32),
                normal=jnp.zeros((L, 3)), min_dist=jnp.ones((L,)),
                max_dist=jnp.ones((L,)), valid=jnp.zeros((L,), bool),
                angle=jnp.zeros((L,)),
            )
        return self._empty_lp

    def track_monocular(self, img, timestamp: float, imu_samples=None) -> Optional[np.ndarray]:
        """img: (H,W) grayscale array. Returns 4x4 Tcw or None
        (System::TrackMonocular, System.h:120)."""
        if imu_samples is not None:
            self.feed_imu(imu_samples)
        from .pipeline import programs
        img = jnp.asarray(img)
        ready, lp, ids, R0, t0 = self.tracker.prepare_frame(timestamp)
        if not ready:
            lp = self._dummy_local_points()
            R0 = jnp.eye(3)
            t0 = jnp.zeros(3)
        # extraction + matching + pose LM in ONE dispatch (on init/reloc
        # frames the dummy point set makes the track half a cheap no-op)
        feats, res = programs.extract_and_track(
            self.cam, self.geom_cam, img, lp, R0, t0,
            n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
            scale=self.cfg.scale_factor, ini_th=self.cfg.ini_th_fast,
            min_th=self.cfg.min_th_fast,
            th=self.tracker._prepared_th if ready else 1.0,
            undistort=self.cam.kind != cameras.PINHOLE,
        )
        return self.track_features(
            feats, timestamp, precomputed=(res,) if ready else None
        )

    def track_monocular_pipelined(self, img, timestamp: float,
                                  imu_samples=None) -> Optional[np.ndarray]:
        """Deep-pipelined monocular tracking.

        The synchronous tracker waits for each frame's device->host fetch
        before it can do that frame's map bookkeeping. Here every per-frame
        fetch (features for keyframe bookkeeping, the projection-track
        result) is started as an ASYNC copy at dispatch time and harvested
        `pipeline_depth` calls later, so the device computes later frames
        while the host does bookkeeping for earlier ones.

        Per call: retire the oldest in-flight frame (harvest its result +
        map bookkeeping, returning its pose — output latency is
        `pipeline_depth` frames), then dispatch this frame's extraction AND
        projection-track in one go (the track program chains on the
        extraction's device buffers without any host round trip). The
        motion-model prediction composes `depth` frame deltas since
        bookkeeping lags that far behind. Call `flush_pipeline()` after the
        last frame.

        The reference hides the same latencies with its Tracking /
        LocalMapping thread overlap (SURVEY §2.3 P1); a lagged deep pipeline
        is the XLA-native equivalent for a single async device stream."""
        from .pipeline import programs
        from .utils.fetch import device_fetch_async

        if imu_samples is not None:
            self.feed_imu(imu_samples)
        out = None
        if len(self._pipe) >= self.cfg.pipeline_depth:
            out = self._retire_oldest()
        img = jnp.asarray(img)
        feats = programs.extract_only(
            self.cam, img, n_features=self.cfg.n_features,
            n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
            ini_th=self.cfg.ini_th_fast, min_th=self.cfg.min_th_fast,
            undistort=self.cam.kind != cameras.PINHOLE,
        )
        return self._pipeline_track_dispatch(feats, timestamp, out)

    def track_stereo_pipelined(self, img_left, img_right, timestamp: float,
                               imu_samples=None) -> Optional[np.ndarray]:
        """Deep-pipelined rectified-stereo(-inertial) tracking: the stereo
        twin of track_monocular_pipelined. Both extractions + the row
        matcher run as one device dispatch (programs.extract_stereo_only),
        the projection-track chains on device, and every per-frame fetch is
        an async copy harvested `pipeline_depth` calls later. This is the
        high-throughput driver for the reference's flagship stereo-inertial
        mode (ros_stereo_inertial.cc:72-120)."""
        from .pipeline import programs

        if imu_samples is not None:
            self.feed_imu(imu_samples)
        out = None
        if len(self._pipe) >= self.cfg.pipeline_depth:
            out = self._retire_oldest()
        feats = programs.extract_stereo_only(
            self.cam, jnp.asarray(img_left), jnp.asarray(img_right),
            n_features=self.cfg.n_features,
            n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
            ini_th=self.cfg.ini_th_fast, min_th=self.cfg.min_th_fast,
            undistort=self.cam.kind != cameras.PINHOLE,
        )
        return self._pipeline_track_dispatch(feats, timestamp, out)

    def _pipeline_track_dispatch(self, feats, timestamp: float, out):
        """Shared tail of the deep-pipelined entry points: chain the pose
        seed + projection-track on the device-resident features, start the
        packed async fetch, and enqueue the frame context."""
        from .pipeline import programs
        from .utils.fetch import device_fetch_async

        steps = len(self._pipe) + 1
        prev = self._pipe[-1] if self._pipe else None
        ready, lp, ids, R0, t0 = self.tracker.prepare_frame(
            timestamp, steps=steps
        )
        prepared = res_dev = None
        if ready:
            # pose seed: chain on the PREVIOUS frame's device-resident track
            # result (one velocity step ahead) instead of extrapolating the
            # host pose `steps` frames — the prediction is then never more
            # than one frame stale, whatever the pipeline depth. Falls back
            # to the host prediction when the chained frame tracked thin.
            # (single fused dispatch — see programs.chain_seed)
            if prev is not None and prev.get("res_dev") is not None:
                pres = prev["res_dev"]
                vel = self.tracker.velocity
                if vel is not None:
                    vR = vel[:3, :3].astype(np.float32)
                    vt = vel[:3, 3].astype(np.float32)
                else:
                    vR = np.eye(3, dtype=np.float32)
                    vt = np.zeros(3, np.float32)
                R0, t0 = programs.chain_seed(
                    pres.R, pres.t, pres.n_inliers, vR, vt,
                    jnp.asarray(R0), jnp.asarray(t0),
                    min_matches=self.cfg.min_track_matches,
                )
            res = programs.track_only(
                self.geom_cam, feats, lp, R0, t0,
                th=max(self.tracker._prepared_th, 2.0 if steps > 1 else 1.0),
                n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
            )
            res_dev = res
            # ONE packed async fetch for everything this frame sends home
            # (features + track result), instead of two round-trips
            fetch = device_fetch_async((feats, tuple(res)))
            prepared = self.tracker._prepared
        else:
            fetch = device_fetch_async((feats, None))
        self._pipe.append({
            "ts": timestamp,
            "fetch": fetch,
            "has_res": ready,
            "res_dev": res_dev,
            "prepared": prepared,
            "ctx": self.tracker.capture_frame_context(),
        })
        return out

    def _retire_oldest(self) -> Optional[np.ndarray]:
        """Harvest the oldest in-flight frame's async fetches and run its
        deferred map bookkeeping."""
        from .pipeline import programs

        e = self._pipe.pop(0)
        feats_host, res_tuple = e["fetch"].get()
        self.tracker.restore_frame_context(e["ctx"])
        pre = None
        if e["has_res"]:
            res = programs.TrackResult(*res_tuple)
            pre = (res, e["prepared"])
        return self.track_features(feats_host, e["ts"], precomputed=pre)

    def flush_pipeline(self) -> Optional[np.ndarray]:
        """Retire all in-flight frames of the pipelined tracking path;
        returns the last frame's pose."""
        out = None
        while self._pipe:
            out = self._retire_oldest()
        return out

    def track_stereo(self, img_left, img_right, timestamp: float,
                     imu_samples=None) -> Optional[np.ndarray]:
        """Rectified stereo pair (System::TrackStereo, System.h:109)."""
        from .pipeline import programs

        if imu_samples is not None:
            self.feed_imu(imu_samples)
        img_l = jnp.asarray(img_left)
        img_r = jnp.asarray(img_right)
        ready, lp, ids, R0, t0 = self.tracker.prepare_frame(timestamp)
        if not ready:
            lp = self._dummy_local_points()
            R0 = jnp.eye(3)
            t0 = jnp.zeros(3)
        fl, res = programs.extract_and_track_stereo(
            self.cam, self.geom_cam, img_l, img_r, lp, R0, t0,
            n_features=self.cfg.n_features, n_levels=self.cfg.n_levels,
            scale=self.cfg.scale_factor, ini_th=self.cfg.ini_th_fast,
            min_th=self.cfg.min_th_fast,
            th=self.tracker._prepared_th if ready else 1.0,
            undistort=self.cam.kind != cameras.PINHOLE,
        )
        return self.track_features(
            fl, timestamp, precomputed=(res,) if ready else None
        )

    def track_stereo_fisheye(self, img_left, img_right, cam_right,
                             R_lr, t_lr, timestamp: float,
                             imu_samples=None,
                             features=None) -> Optional[np.ndarray]:
        """Non-rectified (e.g. KB8 fisheye) stereo: features are undistorted
        per camera, matched under the true epipolar geometry of the extrinsics
        (x_l = R_lr x_r + t_lr), and triangulated depths seed metric map
        points (KannalaBrandt8::matchAndtriangulate / Frame fisheye ctor).
        Matched right-view pixels become second-camera observations in BA
        (BAProblem.obs_rig). `features=(fl, fr)` injects pre-extracted
        per-camera features (tests / external front ends)."""
        from .pipeline import programs

        if imu_samples is not None:
            self.feed_imu(imu_samples)
        if features is not None:
            fl, fr = features
        else:
            fl = frontend.extract(
                jnp.asarray(img_left), n_features=self.cfg.n_features,
                n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
                ini_th=self.cfg.ini_th_fast, min_th=self.cfg.min_th_fast,
            )
            fr = frontend.extract(
                jnp.asarray(img_right), n_features=self.cfg.n_features,
                n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
                ini_th=self.cfg.ini_th_fast, min_th=self.cfg.min_th_fast,
            )
        xy1 = cameras.undistort_points(self.cam, fl.xy)
        xy2 = cameras.undistort_points(cam_right, fr.xy)
        geom_r = cameras.pinhole_equivalent(cam_right)
        depth, ridx, rmatched = programs.fisheye_stereo_depth(
            self.geom_cam, geom_r,
            xy1, fl.level, fl.desc, fl.valid,
            xy2, fr.level, fr.desc, fr.valid,
            jnp.asarray(R_lr), jnp.asarray(t_lr),
        )
        fl = fl._replace(xy=xy1, depth=depth)
        # register the rig extrinsics once: x_r = R_rl x_l + t_rl
        if self.map.rig is None:
            R_lr_n = np.asarray(R_lr, np.float32)
            t_lr_n = np.asarray(t_lr, np.float32)
            self.map.rig = (R_lr_n.T, -R_lr_n.T @ t_lr_n)
        n_kf_before = self.map.n_kf
        pose = self.track_features(fl, timestamp)
        # If this frame became a keyframe, attach its matched RIGHT-view
        # pixels as second-camera observations (the reference creates them
        # in the Frame ctor, Frame.cc:1546-1607; constrained in BA by
        # EdgeSE3ProjectXYZToBody, OptimizableTypes.h:96-160). uv is
        # re-expressed in LEFT pinhole-equivalent intrinsics so BA projects
        # every observation with one camera model.
        if self.map.n_kf > n_kf_before:
            kf = self.map.n_kf - 1
            mp_row = self.map.kf_feat_mp[kf]           # (N,) feature -> point
            rm = np.asarray(rmatched)
            sel = (mp_row >= 0) & rm[: len(mp_row)]
            if sel.any():
                ridx_h = np.asarray(ridx)[: len(mp_row)]
                uv_r = np.asarray(xy2)[ridx_h[sel]]
                g, gr = self.geom_cam, geom_r
                norm = (uv_r - np.array([gr.cx, gr.cy])) / np.array(
                    [gr.fx, gr.fy])
                uv_eq = norm * np.array([g.fx, g.fy]) + np.array([g.cx, g.cy])
                lvl_r = np.asarray(fr.level)[ridx_h[sel]]
                self.map.set_right_observations(
                    kf, mp_row[sel], uv_eq.astype(np.float32), lvl_r)
        return pose

    def track_rgbd(self, img, depth_map, timestamp: float,
                   imu_samples=None) -> Optional[np.ndarray]:
        """RGB-D frame (System::TrackRGBD, System.h:114). With an IMU_RGBD
        sensor config, `imu_samples` carries the inter-frame IMU rows just
        like the mono/stereo entry points (the reference's RGBD-inertial
        node, Examples/ROS/ORB_SLAM3/src/ros_rgbd_inertial.cc)."""
        from .frontend import stereo as stereo_mod

        if imu_samples is not None:
            self.feed_imu(imu_samples)
        f = frontend.extract(
            jnp.asarray(img), n_features=self.cfg.n_features,
            n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
            ini_th=self.cfg.ini_th_fast, min_th=self.cfg.min_th_fast,
        )
        u_right, depth = stereo_mod.depth_to_stereo(
            self.cam, f, jnp.asarray(depth_map)
        )
        f = f._replace(u_right=u_right, depth=depth)
        f = self._undistort(f)
        return self.track_features(f, timestamp)

    def _undistort(self, feats):
        if self.cam.kind == cameras.PINHOLE:
            return feats
        return feats._replace(xy=cameras.undistort_points(self.cam, feats.xy))

    def track_features(self, feats: frontend.Features, timestamp: float,
                       precomputed=None):
        """Entry point when features are produced externally (tests, stereo
        pipelines, benchmarking without the extractor)."""
        from .utils.profiling import GLOBAL_TIMER as _T

        # IMU-health watchdog: mbBadImu resets the active map from the
        # tracking side (LocalMapping.cc:191-198, Tracking.cc:2023-2028)
        if self.mapper.bad_imu:
            self.mapper.bad_imu = False
            self.mapper._imu_init_failures = 0
            self.reset_active_map()
        # deferred world-transform reconciliation from the async mapper
        if self._map_queue is not None and self.mapper.map_transformed:
            self.mapper.map_transformed = False
            tr = self.mapper.last_transform
            if tr is not None:
                self.tracker.apply_world_transform(*tr)
        with _T.stage("track_map"):
            pose = self.tracker.track(feats, timestamp, precomputed=precomputed)
        kf = self.tracker.pending_kf
        if kf is not None and self.n_keyframes() >= 2:
            if self._map_queue is not None:
                self._map_queue.put(kf)  # unbounded — never blocks tracking
                return pose
            self.mapper.process_keyframe(kf)
            if self.mapper.map_transformed:
                # IMU init rescaled/rotated the world: re-seat the tracker
                self.mapper.map_transformed = False
                self.tracker.last_R = self.map.kf_R[kf].copy()
                self.tracker.last_t = self.map.kf_t[kf].copy()
                self.tracker.body_vel = self.map.kf_vel[kf].copy()
                self.tracker.velocity = None
                self.tracker.vi_prior = None
                self.tracker._last_prediction = None
            if self.cfg.enable_loop_closing:
                corrected = self.loopcloser.process_keyframe(kf)
                if corrected:
                    # tracking must continue from the corrected KF pose (and
                    # welded velocity, for inertial merges)
                    self.tracker.last_R = self.map.kf_R[kf].copy()
                    self.tracker.last_t = self.map.kf_t[kf].copy()
                    self.tracker.body_vel = self.map.kf_vel[kf].copy()
                    self.tracker.velocity = None
                    self.tracker.vi_prior = None
                    self.tracker._last_prediction = None
        return pose

    def _worker_device(self):
        """Device the BACKGROUND threads (mapper/loopcloser/GBA) compute on,
        or None for the default device.

        Rule: when the default device is an accelerator, background work
        runs on the host CPU backend, so its BA programs never queue ahead of
        a tracked frame on the accelerator's stream. The reference runs
        LocalMapping/LoopClosing/GBA on CPU threads too; this is the same
        split, expressed as a jax.default_device placement. Inertial configs
        route too: preintegration buffers are pulled to host when the worker
        stacks them (mapper._stack_preints). If JAX was started without its
        CPU backend, background work stays on the accelerator, with a
        warning."""
        import warnings
        import jax as _jax

        if _jax.default_backend() == "cpu":
            return None  # already on host — nothing to route
        try:
            return _jax.local_devices(backend="cpu")[0]
        except RuntimeError as e:  # CPU backend not initialized
            warnings.warn(f"no CPU backend ({e}); mapping, loop closing and "
                          "GBA share the accelerator with tracking")
            return None

    def _mapping_worker(self):
        """Background LocalMapping/LoopClosing consumer — the reference's
        pipeline parallelism (SURVEY §2.3 P1) as a host thread; device work
        releases the GIL so tracking overlaps mapping."""
        import contextlib
        import traceback
        import jax as _jax

        dev = self.worker_device
        while True:
            kf = self._map_queue.get()
            if kf is None:
                return
            try:
                ctx = (_jax.default_device(dev) if dev is not None
                       else contextlib.nullcontext())
                with ctx:
                    self.mapper.process_keyframe(kf)
                    if self.cfg.enable_loop_closing:
                        self.loopcloser.process_keyframe(kf)
            except Exception:
                # keep the worker alive (a single bad KF must not kill
                # mapping) but COUNT the failure — tests and the bench
                # assert this stays 0 so worker-thread bugs can't hide
                # behind the resilience policy
                self.worker_errors += 1
                traceback.print_exc()
            finally:
                self._map_queue.task_done()

    def shutdown(self, atlas_path: str | None = None):
        """System::Shutdown (System.cc:573): drain pipeline workers and
        optionally persist the Atlas."""
        self.wait_idle()
        if atlas_path:
            self.save_atlas(atlas_path)

    def print_time_stats(self):
        """Tracking::PrintTimeStats equivalent (REGISTER_TIMES report)."""
        from .utils.profiling import GLOBAL_TIMER

        GLOBAL_TIMER.print_time_stats()

    def wait_idle(self):
        """Drain the async mapping queue and any background GBA
        (Shutdown's spin-wait analog)."""
        if self._map_queue is not None:
            self._map_queue.join()
        self.loopcloser.join_gba()

    # --------------------------------------------------------------- queries
    @property
    def state(self) -> str:
        return STATE_NAMES[self.tracker.state]

    def n_keyframes(self) -> int:
        return len(self.map.kf_ids())

    def n_map_points(self) -> int:
        return len(self.map.mp_ids())

    # ------------------------------------------------------------ mode/reset
    def activate_localization_mode(self):
        """Tracking-only: no new keyframes/map growth (System.h:123)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def reset(self):
        """Full reset: drop all maps and state (System::Reset)."""
        mc = self.map.cfg
        from .map.state import MapState
        self.map = MapState(mc)
        self.tracker.map = self.map
        self.mapper.map = self.map
        self.loopcloser.map = self.map
        self.tracker.state = 0
        self.tracker.last_kf = -1
        self.tracker._init_feats = None
        self.tracker.records.clear()
        self.mapper.recent_mps.clear()
        self.tracker.kf_preint.clear()

    def reset_active_map(self):
        """Drop only the active sub-map (System::ResetActiveMap); resets the
        per-map inertial-init staging so a fresh attempt starts clean."""
        self.n_map_resets = getattr(self, "n_map_resets", 0) + 1
        m = self.map
        for mp in m.mp_ids(m.active_map):
            m.remove_point(int(mp))
        for kf in m.kf_ids(m.active_map):
            m.kf_valid[kf] = False
            self.kfdb.erase(int(kf))
        m.map_imu_init[m.active_map] = False
        m.map_viba1[m.active_map] = False
        m.map_viba2[m.active_map] = False
        self.mapper.viba1_done = False
        self.mapper.viba2_done = False
        self.mapper.t_imu_init = None
        self.mapper.t_init_accum = 0.0
        self.mapper.recent_mps.clear()
        self.tracker.state = 1
        self.tracker.last_kf = -1
        self.tracker._init_feats = None
        self.tracker.velocity = None
        self.tracker.vi_prior = None
        self.tracker.kf_preint.clear()
        if self.imu is not None:
            self.imu.queue.clear()

    # ----------------------------------------------------------- persistence
    def save_atlas(self, path: str):
        """Checkpoint the whole multi-map state (System::SaveAtlas)."""
        from .map.persistence import save_atlas

        save_atlas(self.map, path, voc=self.voc)

    def load_atlas(self, path: str, new_session: bool = True):
        """Load a previous session's atlas; with new_session=True a fresh
        active sub-map is opened so this session's tracking starts clean and
        can later merge into the loaded maps (multi-session SLAM,
        System.cc:194-207)."""
        from .map.persistence import load_atlas

        self.map = load_atlas(path, voc=self.voc)
        # rebuild the BoW database from the stored descriptors
        for kf in self.map.kf_ids():
            self.kfdb.add(int(kf), self.map.kf_feat_desc[kf], self.map.kf_feat_valid[kf])
        if new_session:
            self.map.create_new_map()
        # rewire components to the new map object
        self.tracker.map = self.map
        self.mapper.map = self.map
        self.loopcloser.map = self.map
        self.tracker.state = 0  # NO_IMAGES_YET
        self.tracker.last_kf = -1
        self.tracker._init_feats = None

    # --------------------------------------------------------------- export
    def trajectory(self) -> list[tuple[float, np.ndarray]]:
        """Full-frame trajectory rebuilt against (possibly BA-refined) reference KFs
        (SaveTrajectoryTUM pattern, System.cc:635): Tcw = Tcr @ Trw(refKF)."""
        out = []
        self.map.lock.acquire()  # consistent poses vs the mapping worker
        try:
            return self._trajectory_locked(out)
        finally:
            self.map.lock.release()

    def _trajectory_locked(self, out):
        for rec in self.tracker.records:
            if rec.lost or rec.ref_kf < 0:
                continue
            ref = rec.ref_kf
            # walk to a live ancestor, composing each culled KF's frozen
            # relative-to-parent transform (Trw = Trw * mTcp chain,
            # System.cc:760-847, KeyFrame.h:392)
            T_chain = np.eye(4, dtype=np.float32)
            while ref >= 0 and not self.map.kf_valid[ref]:
                T_chain = T_chain @ self.map.kf_Tcp[ref]
                ref = int(self.map.kf_parent[ref])
            if ref < 0:
                continue
            T_rw = np.eye(4, dtype=np.float32)
            T_rw[:3, :3] = self.map.kf_R[ref]
            T_rw[:3, 3] = self.map.kf_t[ref]
            out.append((rec.timestamp, rec.T_cr @ T_chain @ T_rw))
        return out

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only trajectory (System::SaveKeyFrameTrajectoryTUM)."""
        with open(path, "w") as f:
            for kf in self.map.kf_ids():
                T_wc = np.eye(4, dtype=np.float32)
                T_wc[:3, :3] = self.map.kf_R[kf].T
                T_wc[:3, 3] = -self.map.kf_R[kf].T @ self.map.kf_t[kf]
                q = np.asarray(lie.mat_to_quat(jnp.asarray(T_wc[:3, :3])))
                t = T_wc[:3, 3]
                f.write(
                    f"{self.map.kf_time[kf]:.6f} {t[0]:.7f} {t[1]:.7f} "
                    f"{t[2]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
                )

    def save_trajectory_euroc(self, path: str):
        """EuRoC format: TUM fields with nanosecond timestamps
        (System::SaveTrajectoryEuRoC, System.cc:730)."""
        with open(path, "w") as f:
            for ts, T_cw in self.trajectory():
                T_wc = np.linalg.inv(T_cw)
                q = np.asarray(lie.mat_to_quat(jnp.asarray(T_wc[:3, :3])))
                t = T_wc[:3, 3]
                f.write(
                    f"{int(ts*1e9)} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
                )

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 3x4 row-major T_wc per line
        (System::SaveTrajectoryKITTI, System.cc:1275)."""
        with open(path, "w") as f:
            for ts, T_cw in self.trajectory():
                T_wc = np.linalg.inv(T_cw)
                row = T_wc[:3, :4].reshape(-1)
                f.write(" ".join(f"{v:.7e}" for v in row) + "\n")

    def save_trajectory_tum(self, path: str):
        """TUM format: `t x y z qx qy qz qw` of the camera in world
        (System::SaveTrajectoryTUM, System.cc:635)."""
        with open(path, "w") as f:
            for ts, T_cw in self.trajectory():
                T_wc = np.linalg.inv(T_cw)
                q = np.asarray(lie.mat_to_quat(jnp.asarray(T_wc[:3, :3])))
                t = T_wc[:3, 3]
                f.write(
                    f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
                )
