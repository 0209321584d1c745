"""Loop closing and map merging.

Host orchestration of the LoopClosing thread (reference: src/LoopClosing.cc
Run() :103): per new keyframe — detect common regions via the keyframe
database (NewDetectCommonRegions :386), verify with Sim3 RANSAC + guided
matching + Sim3 refinement (DetectCommonRegionsFromBoW :790), then either
correct a loop inside the active map (CorrectLoop :1377 + essential-graph
optimization) or merge two sub-maps (MergeLocal :1697). A global BA follows
significant corrections (RunGlobalBundleAdjustment :3067), launched on its
own transient thread racing the pipeline and aborted by the next verified
loop/merge (mbStopGBA, :1383-1407) — partial LM progress still lands.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..map.state import MapState
from ..ops import cameras, matching
from ..optim import sim3 as sim3_mod
from ..optim import posegraph
from ..utils.config import SlamConfig
from ..utils.fetch import device_fetch
from . import programs


class LoopCloser:
    def __init__(self, cam: cameras.Camera, cfg: SlamConfig, map_state: MapState,
                 kfdb, mapper):
        self.cam = cam
        self.cfg = cfg
        self.map = map_state
        self.kfdb = kfdb
        self.mapper = mapper
        self._rng = np.random.default_rng(11)
        self.n_loops = 0
        self.n_merges = 0
        # diagnostics (§5.5): hypothesis confirmations and why confirmed
        # hypotheses were still rejected
        self.n_confirms = 0
        self.n_scale_rejects = 0
        self.n_gravity_rejects = 0
        # 3 confirmations before correcting (LoopClosing.cc:455-523,495):
        # spatial hits (covisible KFs re-verifying the Sim3 immediately) and
        # temporal hits (consecutive incoming KFs) both count
        self.required_hits = 3
        # PARALLEL pending hypotheses for temporal verification — the
        # reference keeps a VECTOR of covisibility-consistent groups, each
        # with its own consistency counter (mvConsistentGroups,
        # LoopClosing.cc:455-523 / ORB-SLAM2 DetectLoop): with several BoW
        # candidates per keyframe, a single-slot hypothesis thrashes in
        # scenes where every view retrieves a different (but genuine)
        # revisit and no chain ever reaches 3 confirmations.
        self._pendings: list[dict] = []
        # transient background GBA thread (RunGlobalBundleAdjustment,
        # LoopClosing.cc:1669-1681 spawns; :1383-1407 kills on a new loop)
        self._gba_thread = None

    # ------------------------------------------------------------------ main
    def process_keyframe(self, kf: int) -> bool:
        """Returns True if a loop/merge correction was applied. A hypothesis
        needs 3 confirmations before the correction is applied
        (LoopClosing.cc:455-523: <=2 misses tolerated): the initial Sim3
        verification, spatial re-verifications from the current keyframe's
        covisible neighbors, and temporal re-verifications on consecutive
        incoming keyframes all count."""
        m = self.map
        mid = int(m.kf_map_id[kf])
        # detection gates (NewDetectCommonRegions, LoopClosing.cc:413-436):
        # inertial maps wait for the VIBA2 refinement before place recognition
        # (their geometry is still being rescaled); even with the gate relaxed
        # (loop_requires_viba2=False) an inertial map must at least be
        # IMU-INITIALIZED — welding a non-metric, non-gravity-aligned map
        # would run the visual merge branch on inertial data; young maps are
        # skipped
        if self.cfg.is_inertial:
            if self.cfg.loop_requires_viba2 and not m.map_viba2.get(mid, False):
                return False
            if not m.map_imu_init.get(mid, False):
                return False
        if len(m.kf_ids(mid)) < self.cfg.loop_min_kfs:
            return False
        # a pending hypothesis is first re-verified geometrically against the
        # new KF by composing it with the relative motion and re-projecting
        # (DetectAndReffineSim3FromLastKF, LoopClosing.cc:716) — much cheaper
        # and more robust than a fresh BoW detection, and it keeps temporal
        # verification alive across sparse keyframe cadences
        cand_info = None
        if self._pendings:
            # geometric re-verification of the STRONGEST pending hypothesis
            # (DetectAndReffineSim3FromLastKF, LoopClosing.cc:716)
            best = max(self._pendings, key=lambda q: q["hits"])
            cand_info = self._refine_pending(kf, best)
        if cand_info is None:
            cand_info = self._detect(kf)
        if cand_info is None:
            for q in self._pendings:
                q["misses"] += 1
            self._pendings = [q for q in self._pendings if q["misses"] <= 2]
            return False
        cand, s12, R12, t12, n_matches = cand_info
        region = set([cand] + m.covisible_kfs(cand, k=10, min_weight=15))
        matched = None
        for q in self._pendings:
            if q["region"] & region:
                matched = q
                break
        if matched is not None:
            matched["hits"] += 1
            matched["misses"] = 0
            matched["region"] |= region
            matched.update(sim3=(s12, R12, t12), kf=kf, cand=cand)
        else:
            # spatial verification (DetectCommonRegionsFromBoW tail,
            # LoopClosing.cc:1168-1250): covisible KFs of the CURRENT
            # keyframe must re-verify the composed Sim3 by projection; each
            # success is a confirmation, so a well-supported hypothesis can
            # confirm without waiting 3 keyframe insertions
            hits = 1 + self._spatial_verification(kf, cand, s12, R12, t12)
            matched = {"region": region, "hits": hits, "misses": 0,
                       "sim3": (s12, R12, t12), "kf": kf, "cand": cand}
            self._pendings.append(matched)
        # age every OTHER group (a group stays alive only while consecutive
        # keyframes keep re-confirming it — reference consistency semantics)
        for q in self._pendings:
            if q is not matched:
                q["misses"] += 1
        self._pendings = [q for q in self._pendings if q["misses"] <= 2][-8:]
        if matched["hits"] < self.required_hits:
            return False
        cand = matched["cand"]
        s12, R12, t12 = matched["sim3"]
        self._pendings = []
        self.n_confirms += 1
        same_map = m.kf_map_id[cand] == m.kf_map_id[kf]
        import os as _os
        if _os.environ.get("SLAM_DEBUG_LOOPS"):
            import sys as _sys
            from ..ops import lie as _lie
            import jax.numpy as _jnp
            ang = float(_jnp.linalg.norm(_lie.so3_log(_jnp.asarray(R12))))
            print(
                f"[loopcloser] kf={kf} cand={cand} same_map={bool(same_map)} "
                f"s12={s12:.4f} |t12|={float(np.linalg.norm(t12)):.3f} "
                f"rot={ang:.3f} n={n_matches}",
                file=_sys.stderr, flush=True,
            )
        # inertial acceptance gates (LoopClosing.cc:171-198, :287-311):
        # merges must not change scale by >10%; loops must keep gravity —
        # roll/pitch of the correction < 0.008 rad (yaw is free)
        if self.cfg.is_inertial and m.map_imu_init.get(int(m.kf_map_id[kf]), False):
            if not same_map and not (0.9 <= s12 <= 1.1):
                self.n_scale_rejects += 1
                return False
            if same_map:
                from ..ops import lie as _lie
                import jax.numpy as _jnp
                # gravity check on the WORLD-FRAME drift CORRECTION, not the
                # raw relative rotation between the two views: the reference
                # logs (Twc * mg2oScw) — actual cam->world composed with the
                # loop-corrected world->cam — whose rotation is
                # R_cur_w^T R12 R_cand_w and is identity when there is no
                # drift (LoopClosing.cc:171-198). Gating the raw R12 rejects
                # every genuine revisit seen from a different attitude.
                R_corr = (m.kf_R[kf].T.astype(np.float64)
                          @ np.asarray(R12, np.float64)
                          @ m.kf_R[cand].astype(np.float64))
                rot = np.asarray(_lie.so3_log(_jnp.asarray(
                    R_corr.astype(np.float32))))
                if abs(rot[0]) > 0.008 or abs(rot[1]) > 0.008:
                    self.n_gravity_rejects += 1
                    return False
        # a new verified loop/merge supersedes any GBA still refining the
        # PRE-correction geometry: abort it at the next LM-bite boundary and
        # wait for its (partial) write-back before touching poses
        # (LoopClosing.cc:1383-1407 mbStopGBA + thread join)
        self.abort_gba()
        if same_map:
            self._correct_loop(kf, cand, s12, R12, t12)
            self.n_loops += 1
        else:
            self._merge_maps(kf, cand, s12, R12, t12)
            self.n_merges += 1
        return True

    # ----------------------------------------------------- background GBA
    def abort_gba(self):
        """Stop a running background GBA and wait for it to land (partial
        progress is still written back; Optimizer.cc:1891 ForceStop)."""
        t = self._gba_thread
        if t is not None and t.is_alive():
            self.mapper.request_abort_gba()
            t.join()
        self._gba_thread = None

    def join_gba(self):
        """Wait for a running background GBA WITHOUT aborting it."""
        t = self._gba_thread
        if t is not None and t.is_alive():
            t.join()
        self._gba_thread = None

    @property
    def gba_running(self) -> bool:
        t = self._gba_thread
        return t is not None and t.is_alive()

    # ----------------------------------------------------------- detection
    def _detect(self, kf: int):
        """BoW candidates -> Sim3 verification. Returns (candidate_kf,
        s12, R12, t12, n_inliers) with S12 mapping candidate-cam points into
        current-KF cam frame, or None."""
        m = self.map
        # exclude the CONNECTED set — but "connected" means weight >= 15
        # shared points, exactly the reference's semantics:
        # KeyFrameDatabase queries skip GetConnectedKeyFrames
        # (KeyFrameDatabase.cc:128,284), and that set is populated by
        # UpdateConnections with th = 15 (KeyFrame.cc:499). Keyframes with
        # a WEAK residual overlap (1-14 shared points — typical of a
        # drifted revisit) remain loop candidates; excluding every
        # shared-point keyframe starves loop closing in small rooms where
        # persistent landmarks keep old keyframes weakly covisible forever.
        exclude = set([kf]) | {
            c for c, w in m.covisibility(kf).items() if w >= 15
        }
        qbow = self.kfdb.query_vector(kf)
        cands = self.kfdb.detect_candidates(qbow, exclude, m, n_best=3)
        for cand in cands:
            if not m.kf_valid[cand]:
                continue
            # temporal gate: candidate must not be too recent in same map
            if m.kf_map_id[cand] == m.kf_map_id[kf] and abs(cand - kf) < 10:
                continue
            hit = self._verify_sim3(kf, cand)
            if hit is not None:
                return (cand,) + hit
        return None

    def _refine_pending(self, kf: int, p: dict):
        """DetectAndReffineSim3FromLastKF (LoopClosing.cc:716): carry a
        pending hypothesis' Sim3 to the new keyframe by composing it with the
        relative motion since the hypothesis' keyframe, then demand that the
        candidate window still re-projects >= nProjMatches points. Returns
        (cand, s12, R12, t12, n_proj) like _detect, or None."""
        m = self.map
        if p.get("sim3") is None:
            return None
        cand, k0 = p["cand"], p["kf"]
        if not (m.kf_valid[cand] and m.kf_valid[k0]):
            return None
        s0, R0, t0 = p["sim3"]
        # T_kf_k0 from current poses (drift over one KF gap is negligible)
        R_rel = (m.kf_R[kf].astype(np.float64)
                 @ m.kf_R[k0].astype(np.float64).T)
        t_rel = m.kf_t[kf].astype(np.float64) - R_rel @ m.kf_t[k0].astype(
            np.float64)
        s1, R1, t1 = _np_sim3_mul(1.0, R_rel, t_rel, s0, np.asarray(R0, np.float64),
                                  np.asarray(t0, np.float64))
        n_proj = self._count_projection_matches(kf, cand, float(s1), R1, t1)
        if n_proj < 40:
            return None
        return cand, float(s1), R1, t1, int(n_proj)

    def _verify_sim3(self, kf: int, cand: int):
        """SearchByBoW-style matching of map points, Sim3 RANSAC, guided
        refinement (DetectCommonRegionsFromBoW thresholds: >=20 BoW matches,
        >=15 RANSAC inliers, >=20 opt inliers, LoopClosing.cc:795-814)."""
        m = self.map
        node_q = self.kfdb.kf_node.get(kf)
        node_c = self.kfdb.kf_node.get(cand)
        if node_q is None or node_c is None:
            return None
        mp_q = m.kf_feat_mp[kf]
        mp_c = m.kf_feat_mp[cand]
        mask = (
            (node_q[:, None] == node_c[None, :])
            & (node_q[:, None] >= 0)
            & (mp_q >= 0)[:, None]
            & (mp_c >= 0)[None, :]
        )
        if mask.sum() < 10:
            return None
        idx, dist, ok = matching.search_by_window(
            jnp.asarray(m.kf_feat_desc[kf]), jnp.asarray(m.kf_feat_desc[cand]),
            jnp.asarray(mask), th=matching.TH_LOW, ratio=0.9,
        )
        # rotation-histogram check (matcherBoW(0.9, true), LoopClosing.cc:816)
        ok = matching.rotation_consistency(
            jnp.asarray(m.kf_feat_angle[kf]), jnp.asarray(m.kf_feat_angle[cand]),
            idx, ok,
        )
        idx_np, ok_np = device_fetch((idx, ok))
        if ok_np.sum() < 20:
            return None
        # matched 3D points in each camera frame
        q_mp = mp_q
        c_mp = mp_c[idx_np]
        pair_ok = ok_np & (q_mp >= 0) & (c_mp >= 0)
        pair_ok &= m.mp_valid[np.maximum(q_mp, 0)] & m.mp_valid[np.maximum(c_mp, 0)]
        Xq = m.mp_pos[np.maximum(q_mp, 0)] @ m.kf_R[kf].T + m.kf_t[kf]
        Xc = m.mp_pos[np.maximum(c_mp, 0)] @ m.kf_R[cand].T + m.kf_t[cand]
        lv_q = m.kf_feat_level[kf]
        lv_c = m.kf_feat_level[cand, idx_np]

        # bFixedScale (LoopClosing.cc:798-801): scale fixed for all sensors
        # except pure mono; mono-inertial fixes scale only once VIBA2 has
        # made the map metric (before that the loop Sim3 must absorb scale
        # drift of the not-yet-refined map)
        fix_scale = not self.cfg.is_mono
        if self.cfg.is_mono and self.cfg.is_inertial:
            fix_scale = bool(m.map_viba2.get(int(m.kf_map_id[kf]), False))
        key = jnp.asarray(self._rng.integers(0, 2**31, 2), jnp.uint32)
        s, R, t, inl, n = sim3_mod.sim3_ransac(
            self.cam, jnp.asarray(Xq), jnp.asarray(Xc),
            jnp.asarray(lv_q), jnp.asarray(lv_c), jnp.asarray(pair_ok), key,
            fix_scale=fix_scale,
        )
        if int(n) < 15:
            return None
        uv_q = m.kf_feat_xy[kf]
        uv_c = m.kf_feat_xy[cand, idx_np]
        s, R, t, inl2, n2 = sim3_mod.optimize_sim3(
            self.cam, s, R, t,
            jnp.asarray(Xq), jnp.asarray(uv_q), jnp.asarray(lv_q),
            jnp.asarray(Xc), jnp.asarray(uv_c), jnp.asarray(lv_c),
            jnp.asarray(pair_ok), fix_scale=fix_scale,
        )
        s_np, R_np, t_np, n2 = device_fetch((s, R, t, n2))
        if int(n2) < 20:
            return None
        # guided projection growth over the candidate's covisible-window
        # points (SearchByProjection/SearchBySim3, LoopClosing.cc:1062-1091):
        # the refined S12 must re-project >= nProjMatches points of the loop
        # region into the current keyframe
        n_proj = self._count_projection_matches(kf, cand, float(s_np), R_np, t_np)
        if n_proj < 40:
            return None
        return float(s_np), R_np, t_np, int(n2)

    def _spatial_verification(self, kf: int, cand: int, s12, R12, t12,
                              max_checks: int = 4, th: int = 40) -> int:
        """Re-verify the hypothesis from the current KF's best covisible
        keyframes: compose the verified S12 with each neighbor's relative
        pose and demand the candidate window still re-projects >= th points
        (the reference's covisible-KF spatial verification,
        LoopClosing.cc:1168-1250 / DetectCommonRegionsFromLastKF). Returns
        the number of confirming neighbors."""
        m = self.map
        n_ok = 0
        for ki in m.covisible_kfs(kf, k=max_checks, min_weight=15):
            if not m.kf_valid[ki]:
                continue
            R_rel = (m.kf_R[ki].astype(np.float64)
                     @ m.kf_R[kf].astype(np.float64).T)
            t_rel = (m.kf_t[ki].astype(np.float64)
                     - R_rel @ m.kf_t[kf].astype(np.float64))
            s1, R1, t1 = _np_sim3_mul(1.0, R_rel, t_rel, s12,
                                      np.asarray(R12, np.float64),
                                      np.asarray(t12, np.float64))
            if self._count_projection_matches(int(ki), cand, float(s1), R1, t1) >= th:
                n_ok += 1
        return n_ok

    def _count_projection_matches(self, kf: int, cand: int, s12, R12, t12) -> int:
        """Project the candidate window's map points through S12 into the
        current KF's camera and count window matches."""
        m = self.map
        window = [cand] + m.covisible_kfs(cand, k=10, min_weight=15)
        pts = m.local_point_ids(window, cap=self.cfg.local_points_cap)
        if len(pts) == 0:
            return 0
        # candidate-cam coords -> current-cam coords via S12, then express as
        # world points for the CURRENT KF pose by undoing its Tcw
        Xc_cam = m.mp_pos[pts] @ m.kf_R[cand].T + m.kf_t[cand]
        Xq_cam = s12 * (Xc_cam @ R12.T) + t12
        Rq, tq = m.kf_R[kf], m.kf_t[kf]
        X_world = (Xq_cam - tq) @ Rq  # R^T (x - t)
        # rotate viewing normals into the virtual world of the current KF
        R_comb = Rq.T @ R12 @ m.kf_R[cand]
        normals = m.mp_normal[pts] @ R_comb.T
        cap = self.cfg.local_points_cap
        lp = programs.LocalPoints(
            pos=jnp.asarray(_pad(X_world.astype(np.float32), cap)),
            desc=jnp.asarray(_pad(m.mp_desc[pts], cap)),
            normal=jnp.asarray(_pad(normals.astype(np.float32), cap)),
            min_dist=jnp.asarray(_pad(m.mp_min_dist[pts] * s12, cap)),
            max_dist=jnp.asarray(_pad(m.mp_max_dist[pts] * s12, cap)),
            valid=jnp.asarray(_pad(np.ones(len(pts), bool), cap)),
            angle=jnp.asarray(_pad(m.mp_angle[pts], cap)),
        )
        fidx, ok, existing = programs.fuse_project(
            self.cam, jnp.asarray(Rq), jnp.asarray(tq), lp,
            jnp.asarray(m.kf_feat_xy[kf]), jnp.asarray(m.kf_feat_level[kf]),
            jnp.asarray(m.kf_feat_desc[kf]), jnp.asarray(m.kf_feat_valid[kf]),
            jnp.asarray(m.kf_feat_mp[kf]),
            n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
        )
        return int(np.asarray(ok)[: len(pts)].sum())

    # ----------------------------------------------------------- correction
    def _correct_loop(self, kf: int, cand: int, s12, R12, t12):
        """CorrectLoop (LoopClosing.cc:1377): propagate the Sim3 correction
        to the current KF's covisible group, fuse duplicate points, optimize
        the essential graph, run a capped global BA."""
        m = self.map
        # corrected pose of current KF: Scw_corr = S12 * S_cand_cw
        # (points seen from cand frame map into current frame via S12)
        S_cand = (1.0, m.kf_R[cand].astype(np.float64), m.kf_t[cand].astype(np.float64))
        s_corr = s12 * S_cand[0]
        R_corr = R12 @ S_cand[1]
        t_corr = s12 * (R12 @ S_cand[2]) + t12

        # correction transform in world: old Tcw of kf vs corrected Sim3
        # dS = S_corr^-1 * S_old  maps old-world to corrected-world... apply
        # per-KF: S_i_corr = S_i_old * dS_w where dS_w aligns worlds.
        R_old, t_old = m.kf_R[kf].astype(np.float64), m.kf_t[kf].astype(np.float64)
        # world-correction: x_w' = dSw(x_w) with dSw = S_corr^-1 ∘ S_old
        si, Ri, ti = _np_sim3_inv(s_corr, R_corr, t_corr)
        sw, Rw, tw = _np_sim3_mul(si, Ri, ti, 1.0, R_old, t_old)

        window = [kf] + m.covisible_kfs(kf, k=30, min_weight=15)
        pts = m.local_point_ids(window, cap=10**9)

        # snapshot ALL keyframe poses + strong-covisibility links BEFORE the
        # window correction: the essential graph must measure spanning-tree /
        # pre-existing covisibility edges from NON-corrected poses
        # (Optimizer.cc:4527 NonCorrectedSim3), and new cross-loop links
        # created by fusion are identified as covis edges absent pre-fusion
        with m.lock:  # atomic window correction vs tracker reads
            pre_R = m.kf_R.copy()
            pre_t = m.kf_t.copy()
            pre_pairs, _ = m.covisibility_edges(min_weight=100)
            pre_keys = pre_pairs[:, 0] * m.kf_R.shape[0] + pre_pairs[:, 1]

            # transform window KFs: S_i' = S_i ∘ dSw^-1 ; points: p' = dSw(p)
            swi, Rwi, twi = _np_sim3_inv(sw, Rw, tw)
            for k in window:
                R_before = m.kf_R[k].astype(np.float64)
                sk, Rk, tk = _np_sim3_mul(1.0, R_before, m.kf_t[k].astype(np.float64), swi, Rwi, twi)
                m.kf_R[k] = Rk.astype(np.float32)
                m.kf_t[k] = (tk / sk).astype(np.float32)  # renormalize scale into translation
                # rotate the stored world-frame body velocity by the pose
                # correction (Rcor = Rcw_new^T Rcw_old, LoopClosing.cc:1552) —
                # stale velocities wreck the next IMU predictions and were the
                # post-loop tracking-loss trigger on the MH01 replay. The
                # world correction is x' = sw*Rw@x + tw, so velocities scale
                # by sw = 1/sk (Rk.T @ R_before reduces to Rw).
                m.kf_vel[k] = (
                    (Rk.T @ R_before @ m.kf_vel[k].astype(np.float64)) / float(sk)
                ).astype(np.float32)
            m.mp_pos[pts] = (sw * (m.mp_pos[pts].astype(np.float64) @ Rw.T) + tw).astype(np.float32)

        # fuse: project loop-side points into the corrected window KFs
        loop_window = [cand] + m.covisible_kfs(cand, k=20, min_weight=15)
        loop_pts = m.local_point_ids(loop_window, cap=self.cfg.local_points_cap)
        self._fuse_points_into(window, loop_pts)

        # essential-graph optimization over the whole active map
        self._optimize_essential_graph(kf, cand, pre_R, pre_t, pre_keys)
        # full-map BA with abort + new-KF propagation (RunGlobalBundle-
        # Adjustment, LoopClosing.cc:3067), on its own background thread.
        # Reference gate (:1669): inertial maps get the WHOLE-MAP
        # FullInertialBA (7 iters) when the map is < 200 KFs — a visual-only
        # full BA on an inertial map ignores gravity/velocity/bias and warps
        # the map the VI tracker then fights; visual maps get the visual GBA.
        mid = int(m.kf_map_id[kf])
        if self.cfg.is_inertial and m.map_imu_init.get(mid, False):
            if len(m.kf_ids(mid)) < 200:
                self._launch_gba(self.mapper.full_inertial_ba, iters=7)
        else:
            self._global_ba(iters=10)
        m.version += 1

    def _merge_maps(self, kf: int, cand: int, s12, R12, t12):
        """MergeLocal (LoopClosing.cc:1697) / MergeLocal2 (:2451): transform
        the ACTIVE map into the candidate's (older) map frame, relabel, fuse
        the weld window, then a welding BA. In the inertial variant the weld
        preserves gravity alignment (yaw-only rotation, unit scale once both
        maps are metric) and the welding BA is MergeInertialBA."""
        import math

        m = self.map
        active = int(m.kf_map_id[kf])
        target = int(m.kf_map_id[cand])

        # world alignment: dSw maps active-map world coords into target world
        R_old, t_old = m.kf_R[kf].astype(np.float64), m.kf_t[kf].astype(np.float64)
        s_corr = s12 * 1.0
        R_corr = R12 @ m.kf_R[cand].astype(np.float64)
        t_corr = s12 * (R12 @ m.kf_t[cand].astype(np.float64)) + t12
        si, Ri, ti = _np_sim3_inv(s_corr, R_corr, t_corr)
        sw, Rw, tw = _np_sim3_mul(si, Ri, ti, 1.0, R_old, t_old)

        inertial = self.cfg.is_inertial and m.map_imu_init.get(active, False)
        # MergeLocal2 (the inertial weld) requires BOTH maps IMU-initialized
        # (LoopClosing.cc:2451 runs only from the inertial branch where the
        # matched map is metric); welding an uninitialized target and then
        # force-marking it VI-refined would disarm the excitation watchdog on
        # a non-metric frame
        both_inertial = inertial and m.map_imu_init.get(target, False)
        if both_inertial:
            # both worlds are gravity-aligned (-z): project the weld onto a
            # rotation about gravity so neither map's alignment is disturbed
            # (LoopClosing.cc:171-198 yaw-only correction) ...
            c_old = -(R_old.T @ t_old)            # weld KF center, active world
            c_target = sw * (Rw @ c_old) + tw     # where the full weld puts it
            yaw = math.atan2(Rw[1, 0], Rw[0, 0])
            cy, sy = math.cos(yaw), math.sin(yaw)
            Rw = np.array(
                [[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]], np.float64
            )
            # ... and once both scales are metric (post-VIBA1), freeze s=1
            if m.map_viba1.get(active, False) and m.map_viba1.get(target, False):
                sw = 1.0
            # re-anchor the translation so the CURRENT keyframe still lands
            # exactly on its verified corrected pose — projecting the rotation
            # (or freezing scale) without recomputing tw would shift the whole
            # welded map by the discarded roll/pitch/scale times the lever arm
            tw = c_target - sw * (Rw @ c_old)

        # whole-map weld transform: poses, points, velocities, normals,
        # scale-distance bands (Map::ApplyScaledRotation; takes m.lock)
        m.apply_transform(active, float(sw), Rw.astype(np.float32),
                          tw.astype(np.float32))
        with m.lock:  # atomic relabel vs tracker reads
            kfs = m.kf_ids(active)
            mps = m.mp_ids(active)
            m.kf_map_id[kfs] = target
            m.mp_map_id[mps] = target
            m.active_map = int(target)
            if both_inertial:
                # MergeLocal2 force-sets ImuInitialized/BA1/BA2 on the merged
                # map (LoopClosing.cc:2560-2574) — among other things this
                # DISARMS the insufficient-excitation watchdog, which would
                # otherwise reset the whole merged map at the next still
                # moment (its staging clocks restart at zero)
                m.map_imu_init[target] = True
                m.map_viba1[target] = True
                m.map_viba2[target] = True

        # snapshot post-weld-transform / pre-weld-BA poses + covis links: the
        # merge-variant essential graph measures the absorbed map's internal
        # edges from here so the weld-BA refinement of the window gets
        # distributed through the rest of the absorbed map
        # (NonCorrectedSim3 of Optimizer.cc:5683)
        absorbed = [int(k) for k in kfs]
        with m.lock:
            pre_R = m.kf_R.copy()
            pre_t = m.kf_t.copy()
            pre_pairs, _ = m.covisibility_edges(min_weight=100)
            pre_keys = pre_pairs[:, 0] * m.kf_R.shape[0] + pre_pairs[:, 1]

        # weld: fuse current window with candidate window
        window = [kf] + m.covisible_kfs(kf, k=15, min_weight=15)
        loop_window = [cand] + m.covisible_kfs(cand, k=15, min_weight=15)
        loop_pts = m.local_point_ids(loop_window, cap=self.cfg.local_points_cap)
        self._fuse_points_into(window, loop_pts)
        # welding BA over the union window
        if both_inertial:
            self.mapper.merge_inertial_ba(kf, cand)
        else:
            self.mapper.local_ba(kf)
        # merge-variant essential graph (Optimizer.cc:5683, called from
        # MergeLocal LoopClosing.cc:2274): the target map's keyframes and the
        # weld window stay fixed; the REST of the absorbed map is pulled
        # through the pose graph so drift accumulated far from the weld is
        # distributed instead of frozen in
        absorbed_set = set(absorbed)
        fixed_ids = {int(k) for k in m.kf_ids(target)} - absorbed_set
        fixed_ids |= {int(w) for w in window}
        self._optimize_essential_graph(
            kf, cand, pre_R, pre_t, pre_keys, fixed_ids=fixed_ids
        )
        m.version += 1

    def _fuse_points_into(self, kf_window, point_ids):
        """SearchAndFuse (LoopClosing.cc:2895): project `point_ids` into each
        window KF and merge duplicates."""
        m = self.map
        if len(point_ids) == 0:
            return
        cap = self.cfg.local_points_cap
        ids = np.asarray(point_ids)[:cap]
        L = cap
        lp = programs.LocalPoints(
            pos=jnp.asarray(_pad(m.mp_pos[ids], L)),
            desc=jnp.asarray(_pad(m.mp_desc[ids], L)),
            normal=jnp.asarray(_pad(m.mp_normal[ids], L)),
            min_dist=jnp.asarray(_pad(m.mp_min_dist[ids], L)),
            max_dist=jnp.asarray(_pad(m.mp_max_dist[ids], L)),
            valid=jnp.asarray(_pad(np.ones(len(ids), bool), L)),
            angle=jnp.asarray(_pad(m.mp_angle[ids], L)),
        )
        for nb in kf_window:
            fidx, ok, existing = programs.fuse_project(
                self.cam, jnp.asarray(m.kf_R[nb]), jnp.asarray(m.kf_t[nb]), lp,
                jnp.asarray(m.kf_feat_xy[nb]), jnp.asarray(m.kf_feat_level[nb]),
                jnp.asarray(m.kf_feat_desc[nb]), jnp.asarray(m.kf_feat_valid[nb]),
                jnp.asarray(m.kf_feat_mp[nb]),
                n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
            )
            fidx, ok_np, ex = device_fetch((fidx, ok, existing))
            ok_np = ok_np[: len(ids)]
            ex = ex[: len(ids)]
            for j in np.nonzero(ok_np)[0]:
                mp = int(ids[j])
                if not m.mp_valid[mp]:
                    continue
                if ex[j] >= 0 and ex[j] != mp and m.mp_valid[ex[j]]:
                    # loop-side point wins (CorrectLoop replaces map points
                    # with their loop counterparts)
                    m.replace_point(int(ex[j]), mp)
                elif ex[j] < 0:
                    m.add_observation(mp, int(nb), int(fidx[j]))

    def _optimize_essential_graph(self, kf: int, cand: int,
                                  pre_R=None, pre_t=None, pre_keys=None,
                                  fixed_ids=None):
        """Essential graph: spanning tree + strong covisibility (weight>=100)
        + new loop-connection edges + the loop edge (Optimizer.cc:4527 loop
        variant; :5683 merge variant via fixed_ids).

        Edge measurements follow the reference's vScw/NonCorrectedSim3 split:
        spanning-tree and PRE-EXISTING covisibility edges are measured from
        the pre-correction pose snapshot (so the accumulated drift lives in
        the residuals and gets distributed over the whole graph), while NEW
        covisibility links created by loop fusion and the loop edge itself
        are measured from the current (window-corrected) poses — they encode
        the correction constraint. Vertex initial values are the current
        poses; gauge anchors = fixed_ids (default: the loop-side KF).

        Edge building is one vectorized pass (covisibility_edges over the
        observation table + batched relative-pose composition); the solve
        dispatches to dense Cholesky or matrix-free block-Jacobi CG by size
        (posegraph.solve_pose_graph)."""
        m = self.map
        kfs = m.kf_ids()
        if len(kfs) < 4:
            return
        if pre_R is None:
            pre_R, pre_t = m.kf_R, m.kf_t
        if pre_keys is None:
            pre_keys = np.empty(0, np.int64)
        if fixed_ids is None:
            fixed_ids = {int(cand)}
        N = m.kf_R.shape[0]
        K = len(kfs)
        slot_arr = np.full(N, -1, np.int64)
        slot_arr[np.asarray(kfs)] = np.arange(K)

        # --- spanning-tree edges (always pre-correction measurements)
        kfs_np = np.asarray(kfs, np.int64)
        par = m.kf_parent[kfs_np].astype(np.int64)
        tree_ok = (par >= 0) & (slot_arr[np.maximum(par, 0)] >= 0)
        ta_, tb_ = kfs_np[tree_ok], par[tree_ok]
        tree_keys = np.minimum(ta_, tb_) * N + np.maximum(ta_, tb_)

        # --- strong covisibility edges (one pass over the obs table)
        pairs, _w = m.covisibility_edges(min_weight=100)
        if len(pairs):
            ok = (slot_arr[pairs[:, 0]] >= 0) & (slot_arr[pairs[:, 1]] >= 0)
            pairs = pairs[ok]
            ckeys = pairs[:, 0] * N + pairs[:, 1]
            keep = ~np.isin(ckeys, tree_keys)  # dedup vs spanning tree
            pairs, ckeys = pairs[keep], ckeys[keep]
            # links born from loop fusion carry corrected measurements
            born_new = ~np.isin(ckeys, pre_keys)
        else:
            ckeys = np.empty(0, np.int64)
            born_new = np.empty(0, bool)

        ea = np.concatenate([ta_, pairs[:, 0] if len(pairs) else np.empty(0, np.int64),
                             np.asarray([int(kf)], np.int64)])
        eb = np.concatenate([tb_, pairs[:, 1] if len(pairs) else np.empty(0, np.int64),
                             np.asarray([int(cand)], np.int64)])
        use_corr = np.concatenate([
            np.zeros(len(ta_), bool), born_new, np.ones(1, bool),
        ])
        ew = np.concatenate([
            np.ones(len(ta_), np.float32),
            np.ones(len(pairs) if len(pairs) else 0, np.float32),
            np.asarray([10.0], np.float32),  # the loop/merge edge
        ])

        # batched relative measurement S_ab = S_a * S_b^-1 (unit source scale)
        Ra = np.where(use_corr[:, None, None], m.kf_R[ea], pre_R[ea]).astype(np.float64)
        tb = np.where(use_corr[:, None], m.kf_t[eb], pre_t[eb]).astype(np.float64)
        Rb = np.where(use_corr[:, None, None], m.kf_R[eb], pre_R[eb]).astype(np.float64)
        ta = np.where(use_corr[:, None], m.kf_t[ea], pre_t[ea]).astype(np.float64)
        R_rel = np.einsum("kij,klj->kil", Ra, Rb)
        t_rel = ta - np.einsum("kij,kj->ki", R_rel, tb)

        E = len(ea)
        prob = posegraph.PoseGraphProblem(
            s=jnp.ones(K, jnp.float32),
            R=jnp.asarray(m.kf_R[kfs]),
            t=jnp.asarray(m.kf_t[kfs]),
            fixed=jnp.asarray([int(k) in fixed_ids for k in kfs]),
            e_i=jnp.asarray(slot_arr[ea], jnp.int32),
            e_j=jnp.asarray(slot_arr[eb], jnp.int32),
            e_s=jnp.ones(E, jnp.float32),
            e_R=jnp.asarray(R_rel.astype(np.float32)),
            e_t=jnp.asarray(t_rel.astype(np.float32)),
            e_valid=jnp.ones(E, bool),
            e_weight=jnp.asarray(ew, jnp.float32),
        )
        s, R, t, _ = posegraph.solve_pose_graph(
            prob, iters=15, dof4=self.cfg.is_inertial and m.map_viba2.get(m.active_map, False)
        )
        s, R, t = np.asarray(s), np.asarray(R), np.asarray(t)
        with m.lock:  # atomic pose-graph write-back vs tracker reads
            # write back: Tcw = [R | t/s]; transform points via their ref KF
            old_R = m.kf_R[kfs].copy()
            old_t = m.kf_t[kfs].copy()
            for i, k in enumerate(kfs):
                # velocity follows the pose correction (Rcor = Rcw_new^T
                # Rcw_old; LoopClosing.cc:1552 applies the same after Sim3
                # corrections — stale velocities poison IMU prediction).
                # Point write-back is p' = (1/s) Rnew^T(Rold p + ...) so the
                # per-KF world correction scales velocities by 1/s[i].
                m.kf_vel[k] = (
                    (R[i].T @ old_R[i] @ m.kf_vel[k]) / s[i]
                ).astype(np.float32)
                m.kf_R[k] = R[i]
                m.kf_t[k] = t[i] / s[i]
            # correct map points through their first observing KF's
            # correction: p' = Snew^-1 * Told * p, one vectorized transform
            # over all points grouped by reference KF (Optimizer.cc:4836-4870)
            pts = m.mp_ids()
            slot_arr = np.full(m.kf_R.shape[0], -1, np.int64)
            slot_arr[np.asarray(kfs)] = np.arange(K)
            ref = m.mp_first_kf[pts]
            i = slot_arr[ref]
            sel = i >= 0
            pts, i = pts[sel], i[sel]
            pc = (
                np.einsum("kij,kj->ki", old_R[i].astype(np.float64),
                          m.mp_pos[pts].astype(np.float64))
                + old_t[i].astype(np.float64)
            )
            si = s[i][:, None]
            m.mp_pos[pts] = np.einsum(
                "kji,kj->ki", R[i].astype(np.float64), (pc - t[i]) / si
            ).astype(np.float32)
            m.update_point_geometry(pts)

    def _global_ba(self, iters: int = 10):
        self._launch_gba(self.mapper.global_ba, iters=iters)

    def _launch_gba(self, fn, **kw):
        """Launch a full-map BA (visual or inertial) on its own transient
        thread, racing the tracking/mapping pipeline exactly like the
        reference's GBA thread (LoopClosing.cc:1669-1681 `new
        thread(RunGlobalBundleAdjustment)`). The BA snapshots its problem
        under the map lock, optimizes in abortable LM bites, and writes back
        atomically (run_full_map_ba additionally propagates the correction
        through the spanning tree to keyframes/points created meanwhile)."""
        import threading

        if not self.cfg.async_mapping:
            # single-threaded mode (tests, deterministic replays): inline
            fn(**kw)
            return
        self.join_gba()  # at most one GBA at a time (reference semantics)

        def run():
            # same host-CPU routing as the mapping worker (see
            # system._worker_device): GBA must not queue ahead of the
            # latency-critical tracking stream on the accelerator
            dev = getattr(self, "worker_device", None)
            if dev is not None:
                import jax as _jax
                with _jax.default_device(dev):
                    fn(**kw)
            else:
                fn(**kw)

        t = threading.Thread(target=run, daemon=True)
        self._gba_thread = t
        t.start()


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: len(a)] = a[:n]
    return out


def _np_sim3_mul(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta


def _np_sim3_inv(s, R, t):
    si = 1.0 / s
    Rt = R.T
    return si, Rt, -si * (Rt @ t)
