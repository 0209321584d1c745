"""Host tracking state machine.

The per-frame front end of the system: owns the OK/RECENTLY_LOST/LOST ladder
(reference: Tracking.h:133-142 state enum, Tracking.cc:2009 Track()), decides
keyframe insertion, and dispatches the jitted device programs in
pipeline.programs. All heavy compute (extraction, matching, pose LM) runs on
device; this file only does bookkeeping on small numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from .. import frontend
from ..map.state import MapState, MapConfig
from ..ops import lie, cameras, matching
from ..optim import twoview, ba, imu as imu_mod, inertial, pose_opt
from ..utils.config import SlamConfig, MONOCULAR
from . import programs
from .imu_frontend import ImuFrontend
from ..utils.fetch import device_fetch

import jax

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4

STATE_NAMES = {0: "NO_IMAGES_YET", 1: "NOT_INITIALIZED", 2: "OK",
               3: "RECENTLY_LOST", 4: "LOST"}


def _np_feats(feats: frontend.Features) -> dict:
    # packed fetch: one host transfer for the whole pytree (per-field
    # np.asarray pays one device sync EACH)
    f = device_fetch(feats)
    return {
        "xy": f.xy,
        "level": f.level,
        "angle": f.angle,
        "desc": f.desc,
        "valid": f.valid,
        "u_right": f.u_right,
        "depth": f.depth,
    }


@dataclasses.dataclass
class FrameRecord:
    """Per-frame trajectory entry (mlRelativeFramePoses pattern,
    Tracking.h:164-169): pose stored relative to its reference KF so later
    KF optimization transparently improves the exported trajectory."""

    timestamp: float
    ref_kf: int
    T_cr: np.ndarray   # 4x4, cam-in-refKF
    lost: bool


class Tracker:
    def __init__(self, cam: cameras.Camera, cfg: SlamConfig, map_state: MapState,
                 kfdb=None, imu: ImuFrontend | None = None):
        self.cam = cam
        self.cfg = cfg
        self.map = map_state
        self.kfdb = kfdb  # retrieval.database.KeyFrameDatabase (optional)
        self.imu = imu
        self.kf_preint: dict[int, object] = {}   # kf -> Preintegrated (from prev KF)
        self.last_kf_time: float = 0.0
        self.body_vel = np.zeros(3, np.float32)  # body velocity in world
        self.vi_prior = None
        self.state = NO_IMAGES_YET
        self.last_R = np.eye(3, dtype=np.float32)
        self.last_t = np.zeros(3, np.float32)
        self.velocity: Optional[np.ndarray] = None  # 4x4 Tcl (const-velocity)
        self.last_kf: int = -1
        self.frames_since_kf = 0
        self.frame_id = -1
        self.last_feats = None
        self.last_time = 0.0
        self.lost_since: float = 0.0
        # mono init buffers
        self._init_feats = None
        self._init_time = None
        self.records: list[FrameRecord] = []
        self.pending_kf: Optional[int] = None  # set when a KF was created
        self.localization_only = False  # ActivateLocalizationMode (System.h:123)
        self._rng = np.random.default_rng(0)
        # mapper backpressure probe (KeyframesInQueue, Tracking.cc:3904);
        # wired by the system when async mapping is on
        self.queue_probe = None
        self.last_reloc_frame = -(10 ** 9)  # mnLastRelocFrameId
        self._prepared_th = 1.0  # search-window multiplier of the prepared frame

    # ---------------------------------------------------------------- public
    def prepare_frame(self, timestamp: float, steps: int = 1):
        """Pre-compute what the fused per-frame program needs: timestamp
        fault handling, IMU preintegration, pose prediction and the local
        point view. Returns (ready, lp, ids, R0, t0): ready=False means the
        caller must use the non-fused path (init / reloc / wide search).

        `steps` is the motion-model horizon: the deep pipeline prepares frame
        N while bookkeeping is only complete through frame N-steps, so the
        constant-velocity prediction composes `steps` frame deltas."""
        self._run_frame_prologue(timestamp)
        self._prepared_ts = timestamp
        if self.state != OK or self.last_kf < 0:
            return False, None, None, None, None
        R0, t0 = self._predict_pose(steps=steps)
        self._last_prediction = (R0.copy(), t0.copy())
        lp, ids = self._local_points_view()
        self._prepared = (lp, ids, R0, t0)
        self._prepared_th = self._search_th()
        return True, lp, ids, jnp.asarray(R0), jnp.asarray(t0)

    def _search_th(self) -> float:
        """Projection search-window multiplier for the fused track. With no
        motion model yet (first frame after init / reloc) the prediction is a
        whole frame of motion stale — the reference handles this frame with
        the windowless BoW TrackReferenceKeyFrame (Tracking.cc:2205-2212);
        our single fused pass instead widens the window to absorb it."""
        if self.state != OK:
            return 6.0
        if self._imu_ready():
            return 4.0
        if self.velocity is None:
            return 6.0
        return 1.0

    def capture_frame_context(self):
        """Snapshot the per-frame prologue/preparation state so a deep
        pipeline can interleave prepare_frame(N) with the deferred
        bookkeeping of frame N-depth (see System.track_monocular_pipelined).
        Restore with restore_frame_context right before track()."""
        return (
            getattr(self, "_prepared_ts", None),
            getattr(self, "_prepared", None),
            self._pre_frame,
        )

    def restore_frame_context(self, ctx):
        self._prepared_ts, self._prepared, self._pre_frame = ctx

    def _run_frame_prologue(self, timestamp: float):
        self.pending_kf = None
        self._pre_frame = None
        # input-fault handling (Tracking.cc:2039-2094): non-monotonic
        # timestamps flush IMU and open a fresh sub-map; big gaps reset young
        # maps
        if self.state not in (NO_IMAGES_YET, NOT_INITIALIZED):
            if timestamp < self.last_time:
                if self.imu is not None:
                    self.imu.queue.clear()
                self._handle_lost()
            elif timestamp - self.last_time > 1.0 and self.cfg.is_inertial:
                self._handle_lost()
        if self.imu is not None:
            self._pre_frame = self.imu.preintegrate_frame(timestamp)

    def track(self, feats: frontend.Features, timestamp: float,
              precomputed=None) -> Optional[np.ndarray]:
        """Process one frame's features; returns 4x4 Tcw or None if lost.
        `precomputed` is the (res,) of the fused program run against the
        arrays from prepare_frame."""
        self.frame_id += 1
        if getattr(self, "_prepared_ts", None) != timestamp:
            self._run_frame_prologue(timestamp)
        self._precomputed = precomputed
        if self.state == NO_IMAGES_YET:
            self.state = NOT_INITIALIZED

        if self.state == NOT_INITIALIZED:
            if self.cfg.is_mono:
                done = self._initialize_mono(feats, timestamp)
            else:
                done = self._initialize_stereo(feats, timestamp)
            if done:
                self.state = OK
            self.last_time = timestamp
            return self._current_pose() if done else None

        if (self.state == RECENTLY_LOST and self.kfdb is not None
                and not self._imu_ready()):
            # visual relocalization ladder (Tracking.cc:4444). IMU-initialized
            # maps do NOT relocalize while recently lost — they dead-reckon on
            # the IMU and, failing to re-latch within the window, go LOST and
            # spawn a sub-map to merge later (Tracking.cc:2256-2294)
            if self._relocalize(feats):
                self.state = OK
                self.last_reloc_frame = self.frame_id
        ok = self._track_frame(feats, timestamp)
        dead_reckon = False
        if ok:
            self.state = OK
            self.lost_since = 0.0
        else:
            if self._imu_ready() and getattr(self, "_last_prediction", None) is not None:
                # keep dead-reckoning so visual tracking can re-latch
                # (Tracking.cc:2256-2272 RECENTLY_LOST IMU path)
                self.last_R, self.last_t = self._last_prediction
                dead_reckon = True
            if self.state == OK:
                self.state = RECENTLY_LOST
                self.lost_since = timestamp
            elif self.state == RECENTLY_LOST:
                if timestamp - self.lost_since > self.cfg.recently_lost_secs:
                    self.state = LOST
            if self.state == LOST:
                self._handle_lost()
        self.last_time = timestamp
        self.last_feats = feats
        if ok:
            self._record_frame(timestamp, lost=False)
            return self._current_pose()
        if dead_reckon and self.state == RECENTLY_LOST:
            # the reference keeps PUBLISHING IMU-predicted poses for up to
            # 5 s while recently lost (Tracking.cc:2256-2272); the frame is
            # recorded against the last reference KF so export includes it
            self._record_frame(timestamp, lost=False)
            return self._current_pose()
        self._record_frame(timestamp, lost=True)
        return None

    # ------------------------------------------------------------- internals
    def _current_pose(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.last_R
        T[:3, 3] = self.last_t
        return T

    def _record_frame(self, timestamp: float, lost: bool):
        ref = self.last_kf
        T_cw = self._current_pose()
        T_rw = np.eye(4, dtype=np.float32)
        if ref >= 0:
            T_rw[:3, :3] = self.map.kf_R[ref]
            T_rw[:3, 3] = self.map.kf_t[ref]
        T_cr = T_cw @ np.linalg.inv(T_rw)
        self.records.append(FrameRecord(timestamp, ref, T_cr, lost))

    def apply_world_transform(self, s: float, R: np.ndarray, t: np.ndarray):
        """Reconcile the tracker's live pose after an asynchronous map
        transform (IMU-init gravity/scale alignment): world' = s R world + t.
        Camera center moves with the world; Rcw' = Rcw R^T."""
        c = -self.last_R.T @ self.last_t
        c2 = (s * (R @ c) + t).astype(np.float32)
        Rcw2 = (self.last_R @ R.T).astype(np.float32)
        self.last_R = Rcw2
        self.last_t = (-Rcw2 @ c2).astype(np.float32)
        self.body_vel = (s * (R @ self.body_vel)).astype(np.float32)
        self.velocity = None
        # the VI marginalization prior and the cached IMU prediction are
        # expressed in the OLD world — stale after a gravity/scale transform
        # (the reference re-seats frames via UpdateFrameIMU, Tracking.cc:4887)
        self.vi_prior = None
        self._last_prediction = None

    def _register_kf(self, kf: int):
        if self.kfdb is not None:
            m = self.map
            self.kfdb.add(kf, m.kf_feat_desc[kf], m.kf_feat_valid[kf])

    def _initialize_stereo(self, feats: frontend.Features, timestamp: float) -> bool:
        """StereoInitialization (Tracking.cc:2755): one frame with >500
        keypoints seeds the map directly from depth."""
        f = _np_feats(feats)
        if int(f["valid"].sum()) <= 500:
            return False
        m = self.map
        kf = m.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), f, timestamp
        )
        # StereoInitialization spawns EVERY keypoint with measured depth
        # (Tracking.cc:2775-2800) — the 100-plus-close rule applies only to
        # CreateNewKeyFrame spawning (Tracking.cc:3985)
        self._spawn_depth_points(kf, f, max_points=10**9, depth_cap=None,
                                 close_rule=False)
        if self.imu is not None:
            self.imu.on_new_keyframe(timestamp)
            self.last_kf_time = timestamp
        self._register_kf(kf)
        self.last_kf = kf
        self.last_R = m.kf_R[kf].copy()
        self.last_t = m.kf_t[kf].copy()
        self.velocity = None
        self.frames_since_kf = 0
        self.pending_kf = kf
        return True

    def _spawn_depth_points(self, kf: int, f: dict, max_points: int, depth_cap,
                            close_rule: bool = True):
        """Unproject features with measured depth into new map points
        (CreateNewKeyFrame stereo path, Tracking.cc:3985-4070: closest first,
        stop after 100 unless still closer than ThDepth; close_rule=False
        spawns all — the StereoInitialization behavior)."""
        m = self.map
        cam = self.cam
        th_depth = cam.baseline * self.cfg.depth_th_factor
        has_depth = (f["depth"] > 0) & f["valid"] & (m.kf_feat_mp[kf] < 0)
        order = np.argsort(np.where(has_depth, f["depth"], np.inf))
        created = 0
        batch_idx = []
        for fi in order:
            if not has_depth[fi]:
                break
            d = f["depth"][fi]
            if close_rule and created >= 100 and d > th_depth:
                break
            if depth_cap is not None and d > depth_cap:
                break
            batch_idx.append(fi)
            created += 1
            if created >= max_points:
                break
        if not batch_idx:
            return
        batch_idx = np.asarray(batch_idx)
        rays = np.asarray(
            cameras.unproject(self.cam, jnp.asarray(f["xy"][batch_idx]))
        )
        pc = rays * f["depth"][batch_idx][:, None]
        R, t = m.kf_R[kf], m.kf_t[kf]
        pw = (pc - t) @ R  # R^T (pc - t)
        ids = m.add_map_points(
            pw.astype(np.float32), f["desc"][batch_idx], kf, batch_idx
        )
        m.update_point_geometry(ids[ids >= 0])

    def _initialize_mono(self, feats: frontend.Features, timestamp: float) -> bool:
        n_valid = int(np.asarray(feats.valid).sum())
        if self._init_feats is None:
            if n_valid > self.cfg.min_init_matches:
                self._init_feats = feats
                self._init_time = timestamp
            return False
        if n_valid <= self.cfg.min_init_matches:
            self._init_feats = None
            return False

        idx, dist, ok = matching.search_for_initialization(
            self._init_feats, feats, window=100.0, ratio=0.9
        )
        n_matches = int(np.asarray(ok).sum())
        if n_matches < self.cfg.min_init_matches:
            # keep the newer frame as the init candidate (ref does the same)
            self._init_feats = feats
            self._init_time = timestamp
            return False

        uv1 = self._init_feats.xy
        uv2 = feats.xy[idx]
        key = jnp.asarray(self._rng.integers(0, 2**31, 2), jnp.uint32)
        res = twoview.reconstruct(self.cam, uv1, uv2, ok, key)
        if not bool(res.success):
            return False

        self._create_initial_map_mono(
            self._init_feats, feats, idx, res, self._init_time, timestamp
        )
        self._init_feats = None
        return True

    def _create_initial_map_mono(self, f1, f2, match_idx, res, t1, t2):
        """CreateInitialMapMonocular (Tracking.cc:3001): two KFs, the
        triangulated points, a 20-iteration global BA, then median-depth
        normalization to 1."""
        m = self.map
        f1n, f2n = _np_feats(f1), _np_feats(f2)
        R2 = np.asarray(res.R)
        t2v = np.asarray(res.t)
        kf1 = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), f1n, t1)
        kf2 = m.add_keyframe(R2, t2v, f2n, t2, parent=kf1, prev=kf1)

        good = np.asarray(res.good)
        pts = np.asarray(res.points)
        gi = np.nonzero(good)[0]
        feat2 = np.asarray(match_idx)[gi]
        ids = m.add_map_points(pts[gi], f1n["desc"][gi], kf1, gi)
        for j, mp in enumerate(ids):
            if mp >= 0:
                m.add_observation(int(mp), kf2, int(feat2[j]))

        # global BA on the 2-view map
        self._initial_ba(kf1, kf2)

        # median-depth normalization (Tracking.cc:3076-3085)
        mp_ids = m.mp_ids()
        depths = (m.mp_pos[mp_ids] @ m.kf_R[kf1].T + m.kf_t[kf1])[:, 2]
        med = float(np.median(depths))
        if med < 0:
            med = 1.0
        s = 1.0 / med
        m.mp_pos[mp_ids] *= s
        m.kf_t[kf1] *= s
        m.kf_t[kf2] *= s
        # normals/distance bands must reflect the final (scaled) geometry
        m.update_point_geometry(mp_ids)
        if self.imu is not None:
            self.kf_preint[kf2] = self.imu.preintegrate_since_kf(
                t1, t2, with_raw=True)
            self.imu.on_new_keyframe(t2)
            self.last_kf_time = t2
        self._register_kf(kf1)
        self._register_kf(kf2)

        self.last_kf = kf2
        self.last_R = m.kf_R[kf2].copy()
        self.last_t = m.kf_t[kf2].copy()
        self.velocity = None
        self.frames_since_kf = 0
        self.pending_kf = kf2
        self.last_feats = None

    def _initial_ba(self, kf1: int, kf2: int):
        prob = self._build_two_kf_problem(kf1, kf2)
        Rn, tn, pn, inl, _ = ba.bundle_adjust(self.cam, prob, iters=20)
        m = self.map
        m.kf_R[kf2] = np.asarray(Rn[1])
        m.kf_t[kf2] = np.asarray(tn[1])
        ids = self._last_prob_ids
        pos = np.asarray(pn)
        m.mp_pos[ids] = pos[: len(ids)]

    def _build_two_kf_problem(self, kf1: int, kf2: int) -> ba.BAProblem:
        m = self.map
        ids = m.mp_ids()
        self._last_prob_ids = ids
        P = len(ids)
        D = 2
        obs_cam = np.zeros((P, D), np.int32)
        obs_uv = np.zeros((P, D, 2), np.float32)
        obs_level = np.zeros((P, D), np.int32)
        obs_valid = np.zeros((P, D), bool)
        for j, mp in enumerate(ids):
            for s in range(m.cfg.obs_cap):
                kf = m.mp_obs_kf[mp, s]
                if kf < 0:
                    continue
                d = 0 if kf == kf1 else 1
                fi = m.mp_obs_idx[mp, s]
                obs_cam[j, d] = d
                obs_uv[j, d] = m.kf_feat_xy[kf, fi]
                obs_level[j, d] = m.kf_feat_level[kf, fi]
                obs_valid[j, d] = True
        return ba.BAProblem(
            cam_R=jnp.asarray(np.stack([m.kf_R[kf1], m.kf_R[kf2]])),
            cam_t=jnp.asarray(np.stack([m.kf_t[kf1], m.kf_t[kf2]])),
            cam_fixed=jnp.array([True, False]),
            p=jnp.asarray(m.mp_pos[ids]),
            p_valid=jnp.ones((P,), bool),
            obs_cam=jnp.asarray(obs_cam),
            obs_uv=jnp.asarray(obs_uv),
            obs_ur=jnp.full((P, D), -1.0, jnp.float32),
            obs_level=jnp.asarray(obs_level),
            obs_valid=jnp.asarray(obs_valid),
        )

    # ------------------------------------------------------------- main track
    def _local_points_view(self) -> tuple[programs.LocalPoints, np.ndarray]:
        """Select candidate map points: those seen by the reference KF's
        covisibility neighborhood (UpdateLocalKeyFrames/Points,
        Tracking.cc:4250,4206), padded to the static cap."""
        m = self.map
        cap = self.cfg.local_points_cap
        # the view is a pure function of (map contents, reference KF); the
        # map version only moves when the mapper commits, so between
        # keyframes every frame reuses the uploaded device arrays — skipping
        # ~9 MB of host assembly + host->device transfer per frame
        # the lock pins a CONSISTENT multi-array snapshot against the async
        # mapping worker's write-backs (torn local views otherwise; §2.3 P4)
        with m.lock:
            key = (m.version, self.last_kf, cap)
            cached = getattr(self, "_lp_cache", None)
            if cached is not None and cached[0] == key:
                return cached[1], cached[2]
            kfs = [self.last_kf] + m.covisible_kfs(self.last_kf, k=10, min_weight=5)
            # add temporal neighbors
            k = self.last_kf
            for _ in range(3):
                k = m.kf_prev[k] if k >= 0 else -1
                if k >= 0:
                    kfs.append(int(k))
            ids = m.local_point_ids(np.unique(kfs), cap)
            L = cap
            pos = np.zeros((L, 3), np.float32)
            desc = np.zeros((L, 8), np.uint32)
            normal = np.zeros((L, 3), np.float32)
            mind = np.zeros((L,), np.float32)
            maxd = np.zeros((L,), np.float32)
            valid = np.zeros((L,), bool)
            n = len(ids)
            pos[:n] = m.mp_pos[ids]
            desc[:n] = m.mp_desc[ids]
            normal[:n] = m.mp_normal[ids]
            mind[:n] = m.mp_min_dist[ids]
            maxd[:n] = m.mp_max_dist[ids]
            valid[:n] = True
            ang = np.zeros((L,), np.float32)
            ang[:n] = m.mp_angle[ids]
        lp = programs.LocalPoints(
            pos=jnp.asarray(pos), desc=jnp.asarray(desc), normal=jnp.asarray(normal),
            min_dist=jnp.asarray(mind), max_dist=jnp.asarray(maxd),
            valid=jnp.asarray(valid), angle=jnp.asarray(ang),
        )
        self._lp_cache = (key, lp, ids)
        return lp, ids

    def _imu_ready(self) -> bool:
        return (
            self.imu is not None
            and self.map.map_imu_init.get(self.map.active_map, False)
            and self._pre_frame is not None
        )

    def _predict_pose(self, steps: int = 1) -> tuple[np.ndarray, np.ndarray]:
        if self._imu_ready():
            # dead-reckon the body state from the last frame (PredictStateIMU)
            # — the IMU preintegration window already spans up to the current
            # frame's timestamp, so no extra `steps` composition is needed
            Rwb = np.asarray(self.last_R).T
            pwb = -Rwb @ np.asarray(self.last_t)
            Rp, pp, vp = imu_mod.predict_state(
                jnp.asarray(Rwb), jnp.asarray(pwb), jnp.asarray(self.body_vel),
                jnp.asarray(self.imu.bias), self._pre_frame,
            )
            Rp, pp = np.asarray(Rp), np.asarray(pp)
            self.body_vel = np.asarray(vp)
            Rcw = Rp.T
            return Rcw.copy(), (-Rcw @ pp).copy()
        if self.velocity is not None:
            T = self._current_pose()
            for _ in range(max(1, steps)):
                T = self.velocity @ T
            return T[:3, :3].copy(), T[:3, 3].copy()
        return self.last_R.copy(), self.last_t.copy()

    def _track_frame(self, feats: frontend.Features, timestamp: float) -> bool:
        cfg = self.cfg
        if self._precomputed is not None and self.state == OK:
            # (res,) uses the state captured by the matching prepare_frame;
            # (res, prepared) carries it explicitly (deep pipeline, where
            # several frames are prepared before this one is bookkept)
            if len(self._precomputed) == 2:
                res, (lp, ids, R0, t0) = self._precomputed
            else:
                res = self._precomputed[0]
                lp, ids, R0, t0 = self._prepared
            self._precomputed = None
        else:
            R0, t0 = self._predict_pose()
            self._last_prediction = (R0.copy(), t0.copy())
            lp, ids = self._local_points_view()
            # search-window multiplier: the reference's motion-model stage
            # searches at th=7/15 before the th=1 local-map pass
            # (ORBmatcher.cc SearchByProjection th args, Tracking.cc:3500
            # retry at 2*th; SearchLocalPoints th=15 when recently lost with
            # IMU). Our single fused pass must absorb the full prediction
            # error, so widen with IMU (prediction error grows with bias /
            # velocity error), when not OK, and when no motion model exists
            # yet (see _search_th).
            th = self._search_th()
            res = programs.track_against_points(
                self.cam, feats, lp, jnp.asarray(R0), jnp.asarray(t0),
                th=th,
                n_levels=cfg.n_levels, scale=cfg.scale_factor,
            )
        # ONE host<->device round trip for the whole result (skipped when the
        # deep pipeline already harvested it via an async fetch)
        if not isinstance(res[0], np.ndarray):
            res = programs.TrackResult(*device_fetch(tuple(res)))
        n_inl = int(res.n_inliers)
        if n_inl < cfg.min_track_matches:
            # TrackReferenceKeyFrame fallback (Tracking.cc:3254, called from
            # :2210/:2220 when the motion-model projection track fails):
            # BoW-node matching against the reference KF + pose-only LM, then
            # a wide local-map re-track from the recovered pose. Once the map
            # is IMU-initialized the reference trusts the IMU prediction and
            # never falls back (Tracking.cc:2216-2220) — a garbage inertial
            # init must be allowed to fail through to LOST so the watchdog /
            # map-reset ladder can fix it, instead of thrashing OK<->LOST.
            if self._imu_ready():
                return False
            if not self._track_reference_kf(feats):
                return False
            lp, ids = self._local_points_view()
            res = programs.track_against_points(
                self.cam, feats, lp,
                jnp.asarray(self.last_R), jnp.asarray(self.last_t),
                th=3.0, n_levels=cfg.n_levels, scale=cfg.scale_factor,
            )
            res = programs.TrackResult(*device_fetch(tuple(res)))
            n_inl = int(res.n_inliers)
            if n_inl < cfg.min_track_matches:
                return False

        prev_pose = self._current_pose()
        prev_R, prev_t = self.last_R.copy(), self.last_t.copy()
        self.last_R = np.asarray(res.R)
        self.last_t = np.asarray(res.t)
        if self._imu_ready() and self.last_kf >= 0:
            self._vi_refine(feats, res, ids, timestamp)
        dt = max(timestamp - self.last_time, 1e-6)
        # body velocity estimate (world frame) from camera-center motion
        c_prev = -prev_R.T @ prev_t
        c_new = -self.last_R.T @ self.last_t
        self.body_vel = ((c_new - c_prev) / dt).astype(np.float32)
        # constant-velocity model: Tcl = Tcw_new @ inv(Tcw_prev)
        self.velocity = self._current_pose() @ np.linalg.inv(prev_pose)

        # found/visible stats (MapPoint::IncreaseFound/Visible)
        m = self.map
        vis = np.asarray(res.visible)[: len(ids)]
        inl = np.asarray(res.inlier)[: len(ids)]
        m.mp_visible[ids[vis]] += 1
        m.mp_found[ids[inl]] += 1

        self.frames_since_kf += 1
        n_ct = n_cu = 0
        if not cfg.is_mono:
            n_ct, n_cu = self._close_point_counts(feats, res, ids)
        ok_state = n_inl >= (
            cfg.min_local_inliers if self.state == OK else cfg.min_track_matches
        )
        # KF decision: visual modes insert only from frames that pass the OK
        # gate (reference: `bNeedKF && bOK`, Tracking.cc:2644-2658) — a weak
        # 20-inlier pose must never seed a keyframe, it anchors the map to a
        # biased estimate. Inertial modes additionally insert while
        # RECENTLY_LOST (mInsertKFsLost, same lines + the c4 rule): weak
        # stretches are exactly when the map must grow back under the camera.
        insert_ok = ok_state or (
            cfg.is_inertial
            and self.state == RECENTLY_LOST
            and n_inl >= cfg.min_track_matches
        )
        if (
            not self.localization_only
            and insert_ok
            and self._need_new_kf(n_inl, timestamp, n_ct, n_cu)
        ):
            self._create_new_kf(feats, timestamp, res, ids)
        return ok_state

    def _vi_refine(self, feats, res, ids, timestamp):
        """Visual-inertial pose refinement for the current frame
        (PoseInertialOptimizationLastKeyFrame, Optimizer.cc:435): reprojection
        of the tracked matches + preintegration from the last keyframe +
        bias random walk, on the 15-dof body state. The inertial factor spans
        [last KF, CURRENT frame] (mpImuPreintegratedFromLastKF semantics) —
        the prologue's preintegrate_frame already advanced the accumulator to
        `timestamp`, so this hits the incremental fast path."""
        from ..optim import inertial, pose_opt
        m = self.map
        kf = self.last_kf
        pre = self.imu.preintegrate_since_kf(self.last_kf_time, timestamp)
        if float(pre.dT) <= 1e-6:
            return
        Rbc = np.asarray(self.imu.calib.Rbc)
        tbc = np.asarray(self.imu.calib.tbc)
        Rcb = Rbc.T
        tcb = -Rcb @ tbc
        # previous KF body state
        Rwc_k = m.kf_R[kf].T
        cw_k = -Rwc_k @ m.kf_t[kf]
        prev = inertial.VIState(
            Rwb=jnp.asarray(Rwc_k @ Rbc.T),
            pwb=jnp.asarray(cw_k - (Rwc_k @ Rbc.T) @ tbc),
            vel=jnp.asarray(m.kf_vel[kf]),
            bias=jnp.asarray(m.kf_bias[kf]),
        )
        # current state from the visual solution
        Rwc = self.last_R.T
        cw = -Rwc @ self.last_t
        Rwb = Rwc @ Rbc.T
        state0 = inertial.VIState(
            Rwb=jnp.asarray(Rwb),
            pwb=jnp.asarray(cw - Rwb @ tbc),
            vel=jnp.asarray(self.body_vel),
            bias=jnp.asarray(self.imu.bias),
        )
        match_feat = np.asarray(res.match_feat)[: len(ids)]
        inl = np.asarray(res.inlier)[: len(ids)]
        L = res.match_feat.shape[0]
        uv = np.zeros((L, 2), np.float32)
        lvl = np.zeros((L,), np.int32)
        ok = np.zeros((L,), bool)
        fxy = np.asarray(feats.xy)
        flv = np.asarray(feats.level)
        sel = inl & (match_feat >= 0)
        uv[: len(ids)][sel] = fxy[match_feat[sel]]
        lvl[: len(ids)][sel] = flv[match_feat[sel]]
        ok[: len(ids)] = sel
        pos = np.zeros((L, 3), np.float32)
        pos[: len(ids)] = m.mp_pos[ids]
        obs = pose_opt.PoseObs(
            p_world=jnp.asarray(pos), uv=jnp.asarray(uv),
            u_right=jnp.full((L,), -1.0), level=jnp.asarray(lvl),
            valid=jnp.asarray(ok),
        )
        st, inl2, n2, nxt = inertial.pose_inertial_optimize(
            self.cam, state0, prev, pre, obs,
            (jnp.asarray(Rcb.astype(np.float32)), jnp.asarray(tcb.astype(np.float32))),
            self.vi_prior if self.vi_prior is not None else inertial.empty_prior(),
        )
        n2, st_np = device_fetch((n2, st))
        if int(n2) >= self.cfg.min_track_matches:
            Rwb_n, pwb_n = st_np.Rwb, st_np.pwb
            Rwc_n = Rwb_n @ Rbc
            cw_n = pwb_n + Rwb_n @ tbc
            self.last_R = Rwc_n.T
            self.last_t = -Rwc_n.T @ cw_n
            self.body_vel = st_np.vel
            self.imu.bias = st_np.bias
            self.vi_prior = nxt

    def _track_reference_kf(self, feats: frontend.Features) -> bool:
        """TrackReferenceKeyFrame (Tracking.cc:3254): BoW-node-constrained
        matching of the frame's features against the reference KF's map-point
        features (SearchByBoW, ORBmatcher.cc:262, ratio 0.7 + rotation
        histogram) followed by pose-only LM from the last pose. Returns True
        and updates last_R/t on >=10 inliers."""
        m = self.map
        kf = self.last_kf
        if kf < 0 or self.kfdb is None or not m.kf_valid[kf]:
            return False
        kf_node = self.kfdb.kf_node.get(kf)
        if kf_node is None:
            return False
        desc = np.asarray(feats.desc)
        valid = np.asarray(feats.valid)
        word, node = self.kfdb.voc.transform_on_device(desc, valid)
        has_mp = m.kf_feat_mp[kf] >= 0
        mask = (
            (node[:, None] == kf_node[None, :])
            & (node[:, None] >= 0)
            & has_mp[None, :]
            & valid[:, None]
        )
        if mask.sum() < 15:
            return False
        idx, dist, ok = matching.search_by_window(
            feats.desc, jnp.asarray(m.kf_feat_desc[kf]), jnp.asarray(mask),
            th=matching.TH_LOW, ratio=0.7,
        )
        ok = matching.rotation_consistency(
            feats.angle, jnp.asarray(m.kf_feat_angle[kf]), idx, ok
        )
        idx_np, ok_np = device_fetch((idx, ok))
        if ok_np.sum() < 15:
            return False
        mp = m.kf_feat_mp[kf, idx_np]
        pv = ok_np & (mp >= 0) & m.mp_valid[np.maximum(mp, 0)]
        obs = pose_opt.PoseObs(
            p_world=jnp.asarray(m.mp_pos[np.maximum(mp, 0)]),
            uv=feats.xy, u_right=feats.u_right, level=feats.level,
            valid=jnp.asarray(pv),
        )
        R, t, inl, n = pose_opt.optimize_pose(
            self.cam, jnp.asarray(self.last_R), jnp.asarray(self.last_t), obs
        )
        R_np, t_np, n = device_fetch((R, t, n))
        if int(n) < 10:
            return False
        self.last_R = np.asarray(R_np)
        self.last_t = np.asarray(t_np)
        return True

    def _close_point_counts(self, feats, res, ids) -> tuple[int, int]:
        """Stereo/RGB-D close-point census for NeedNewKeyFrame c1c
        (Tracking.cc:3774-3821): tracked vs untracked features with measured
        depth below ThDepth."""
        depth = np.asarray(feats.depth)
        fvalid = np.asarray(feats.valid)
        th_d = self.cam.baseline * self.cfg.depth_th_factor
        if th_d <= 0:
            th_d = np.inf
        close = fvalid & (depth > 0) & (depth < th_d)
        matched = np.zeros(depth.shape[0], bool)
        mf = np.asarray(res.match_feat)[: len(ids)]
        inl = np.asarray(res.inlier)[: len(ids)]
        sel = inl & (mf >= 0)
        matched[mf[sel]] = True
        return int((close & matched).sum()), int((close & ~matched).sum())

    def _need_new_kf(self, n_inl: int, timestamp: float,
                     n_close_tracked: int = 0, n_close_untracked: int = 0) -> bool:
        """NeedNewKeyFrame (Tracking.cc:3726-3924), full condition set:
        c1a (max frames), c1b (min frames + mapper idle), c1c (stereo
        close-point deficit), c2 (tracked ratio vs reference KF's
        well-observed points), inertial c3 (>=0.5 s since last KF), mono-IMU
        c4 (15<inliers<75 or recently lost), plus the pre-IMU-init 0.25 s
        cadence and the KeyframesInQueue()<3 backpressure gate."""
        cfg = self.cfg
        m = self.map
        if self.localization_only:
            return False
        nkfs = len(m.kf_ids())
        # don't insert right after a relocalization (Tracking.cc:3742)
        if (
            self.frame_id < self.last_reloc_frame + cfg.max_frames_between_kf
            and nkfs > cfg.max_frames_between_kf
        ):
            return False
        imu_init = m.map_imu_init.get(m.active_map, False)
        if cfg.is_inertial and not imu_init:
            # pre-init cadence: one KF every 0.25 s (Tracking.cc:3733-3736)
            return (timestamp - self.last_kf_time) >= 0.25
        queue_len = self.queue_probe() if self.queue_probe is not None else 0
        mapper_idle = queue_len == 0
        # nRefMatches: reference KF's map points with >= minObs observations
        mids = m.kf_feat_mp[self.last_kf]
        mids = mids[mids >= 0]
        min_obs = 3 if nkfs > 2 else 2
        ref_matches = int((m.mp_n_obs[mids] >= min_obs).sum())
        th_ref = cfg.kf_ref_ratio if cfg.is_mono else 0.75
        if nkfs < 2:
            th_ref = 0.4
        need_close = (n_close_tracked < 100) and (n_close_untracked > 70)
        c1a = self.frames_since_kf >= cfg.max_frames_between_kf
        c1b = self.frames_since_kf >= cfg.min_frames_between_kf and mapper_idle
        c1c = (not cfg.is_mono) and (
            n_inl < ref_matches * 0.25 or need_close
        )
        c2 = (n_inl < ref_matches * th_ref or need_close) and n_inl > 15
        c3 = cfg.is_inertial and (timestamp - self.last_kf_time) >= 0.5
        c4 = (
            cfg.sensor == 3  # IMU_MONOCULAR
            and ((15 < n_inl < 75) or self.state == RECENTLY_LOST)
        )
        if not (((c1a or c1b or c1c) and c2) or c3 or c4):
            return False
        if mapper_idle:
            return True
        # mapper busy: non-mono may still queue up to 3 KFs (Tracking.cc:3904)
        return (not cfg.is_mono) and queue_len < 3

    def _create_new_kf(self, feats, timestamp, res, ids):
        m = self.map
        f = _np_feats(feats)
        kf = m.add_keyframe(
            self.last_R, self.last_t, f, timestamp,
            parent=self.last_kf, prev=self.last_kf,
        )
        # associate tracked points with this KF's features
        match_feat = np.asarray(res.match_feat)[: len(ids)]
        inl = np.asarray(res.inlier)[: len(ids)]
        j = np.nonzero(inl & (match_feat >= 0))[0]
        m.add_observations(np.asarray(ids)[j], kf, match_feat[j])
        if not self.cfg.is_mono:
            # stereo/RGB-D: spawn close points from measured depth
            self._spawn_depth_points(kf, f, max_points=10**9, depth_cap=None)
        if self.imu is not None:
            m.kf_vel[kf] = self.body_vel
            m.kf_bias[kf] = self.imu.bias
            self.kf_preint[kf] = self.imu.preintegrate_since_kf(
                self.last_kf_time, timestamp, with_raw=True
            )
            self.imu.on_new_keyframe(timestamp)
            self.last_kf_time = timestamp
        self._register_kf(kf)
        self.last_kf = kf
        self.frames_since_kf = 0
        self.pending_kf = kf

    def _relocalize(self, feats: frontend.Features) -> bool:
        """BoW candidates -> BoW-guided matching -> batched PnP RANSAC ->
        pose LM; success iff enough inliers (Relocalization ladder,
        Tracking.cc:4444-4666)."""
        from ..optim import pnp

        m = self.map
        desc = np.asarray(feats.desc)
        valid = np.asarray(feats.valid)
        word, node = self.kfdb.voc.transform_on_device(desc, valid)
        qbow = self.kfdb.voc.bow_vector(word)
        cands = self.kfdb.detect_relocalization_candidates(qbow, m)
        for kf in cands:
            if not m.kf_valid[kf]:
                continue
            kf_node = self.kfdb.kf_node.get(kf)
            if kf_node is None:
                continue
            # BoW-node-constrained matching to the KF's features that carry
            # map points (SearchByBoW, ORBmatcher.cc:262)
            has_mp = m.kf_feat_mp[kf] >= 0
            mask = (
                (node[:, None] == kf_node[None, :])
                & (node[:, None] >= 0)
                & has_mp[None, :]
                & valid[:, None]
            )
            if mask.sum() < 15:
                continue
            idx, dist, ok = matching.search_by_window(
                feats.desc, jnp.asarray(m.kf_feat_desc[kf]), jnp.asarray(mask),
                th=matching.TH_LOW, ratio=0.75,
            )
            # rotation-histogram check (matcher(0.75, true), Tracking.cc:4469)
            ok = matching.rotation_consistency(
                feats.angle, jnp.asarray(m.kf_feat_angle[kf]), idx, ok
            )
            ok_np = np.asarray(ok)
            if ok_np.sum() < 15:
                continue
            idx_np = np.asarray(idx)
            mp = m.kf_feat_mp[kf, idx_np]
            X = jnp.asarray(m.mp_pos[np.maximum(mp, 0)])
            pv = jnp.asarray(ok_np & (mp >= 0) & m.mp_valid[np.maximum(mp, 0)])
            key = jnp.asarray(self._rng.integers(0, 2**31, 2), jnp.uint32)
            R, t, inl, n_inl = pnp.pnp_ransac(self.cam, X, feats.xy, pv, key)
            if int(n_inl) < 10:
                continue
            # guided growth (Tracking.cc:4560-4640): project the candidate's
            # local map through the PnP pose with a wide window and re-optimize
            lp, _ids = self._candidate_local_view(kf)
            res = programs.track_against_points(
                self.cam, feats, lp, R, t, th=2.5,
                n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
            )
            if int(res.n_inliers) >= max(20, int(n_inl)):
                R, t, n_inl = res.R, res.t, res.n_inliers
            if int(n_inl) >= 20:
                self.last_R = np.asarray(R)
                self.last_t = np.asarray(t)
                self.velocity = None
                self.last_kf = kf
                # relocalized into another sub-map: make it the active map —
                # multi-session recovery (the reference reaches the same end
                # state via the merge path)
                target_map = int(m.kf_map_id[kf])
                if target_map != m.active_map:
                    m.active_map = target_map
                    m.version += 1
                return True
        return False

    def _candidate_local_view(self, kf: int):
        """LocalPoints view around a relocalization candidate keyframe."""
        m = self.map
        cap = self.cfg.local_points_cap
        kfs = [kf] + m.covisible_kfs(kf, k=10, min_weight=5)
        ids = m.local_point_ids(np.unique(kfs), cap)
        L = cap
        pos = np.zeros((L, 3), np.float32)
        desc = np.zeros((L, 8), np.uint32)
        normal = np.zeros((L, 3), np.float32)
        mind = np.zeros((L,), np.float32)
        maxd = np.zeros((L,), np.float32)
        valid = np.zeros((L,), bool)
        n = len(ids)
        pos[:n] = m.mp_pos[ids]
        desc[:n] = m.mp_desc[ids]
        normal[:n] = m.mp_normal[ids]
        mind[:n] = m.mp_min_dist[ids]
        maxd[:n] = m.mp_max_dist[ids]
        valid[:n] = True
        ang = np.zeros((L,), np.float32)
        ang[:n] = m.mp_angle[ids]
        return programs.LocalPoints(
            pos=jnp.asarray(pos), desc=jnp.asarray(desc),
            normal=jnp.asarray(normal), min_dist=jnp.asarray(mind),
            max_dist=jnp.asarray(maxd), valid=jnp.asarray(valid),
            angle=jnp.asarray(ang),
        ), ids

    def _handle_lost(self):
        """Recovery ladder tail (Tracking.cc:2299-2322): young map => reset;
        established map => spawn a fresh sub-map to merge later."""
        m = self.map
        # an inertial map that never reached IMU initialization is useless as
        # a stored sub-map (non-metric, no gravity) — reset it instead of
        # keeping it (Tracking.cc:2299-2322: <10 KFs OR (IMU && !initialized)
        # => ResetActiveMap, else CreateMapInAtlas)
        imu_uninit = (self.cfg.is_inertial
                      and not m.map_imu_init.get(int(m.active_map), False))
        if len(m.kf_ids(m.active_map)) < 10 or imu_uninit:
            self.n_lost_resets = getattr(self, "n_lost_resets", 0) + 1
            # reset active map: drop its kfs/mps AND its inertial staging —
            # a young map dying right after a (bad) IMU init must re-run the
            # init from scratch (Tracking.cc:2305-2310 ResetActiveMap)
            for mp in m.mp_ids(m.active_map):
                m.remove_point(int(mp))
            for kf in m.kf_ids(m.active_map):
                m.kf_valid[kf] = False
                # mirror SLAM.reset_active_map: stale present=True entries
                # would keep displacing live candidates in top-k retrieval
                if self.kfdb is not None:
                    self.kfdb.erase(int(kf))
            m.map_imu_init[m.active_map] = False
            m.map_viba1[m.active_map] = False
            m.map_viba2[m.active_map] = False
        else:
            self.n_submap_spawns = getattr(self, "n_submap_spawns", 0) + 1
            m.create_new_map()
        self.state = NOT_INITIALIZED
        self._init_feats = None
        self.velocity = None
        self.last_kf = -1
