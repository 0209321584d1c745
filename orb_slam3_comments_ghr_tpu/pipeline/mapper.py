"""Local mapping: per-keyframe map building.

Host orchestration of the LocalMapping thread's work (reference:
src/LocalMapping.cc Run() :92): point culling, triangulation of new points
against covisible neighbors, duplicate fusion, windowed local BA, keyframe
culling. Each step's heavy compute is a jitted program from
pipeline.programs / optim.ba; this file owns the bookkeeping.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

import jax

from ..map.state import MapState
from ..ops import cameras
from ..optim import ba, inertial
from ..utils.config import SlamConfig
from . import programs
from ..utils.fetch import device_fetch


def _bite_yield(dt: float = 0.010):
    """Stream-yield between BA bites WITHOUT touching the device: sleep about
    one bite's device time so the next bite is enqueued after any tracker
    programs that arrived meanwhile. A block_until_ready here would stall
    the mapper until the device drains; a host sleep costs the device
    nothing and bounds how much BA work can sit contiguously ahead of a
    tracked frame."""
    import time
    time.sleep(dt)


def _pad_pow2(n: int, lo: int, hi: int) -> int:
    """Round up to a power-of-two bucket to bound jit cache size."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


class LocalMapper:
    def __init__(self, cam: cameras.Camera, cfg: SlamConfig, map_state: MapState,
                 kfdb=None):
        self.cam = cam
        self.cfg = cfg
        self.map = map_state
        self.kfdb = kfdb
        self.recent_mps: list[tuple[int, int]] = []  # (mp_id, birth_kf)
        # shared with the tracker (system wires these for inertial modes)
        self.imu = None
        self.kf_preint: dict[int, object] = {}
        self.t_imu_init: float | None = None
        self.map_transformed = False  # set when apply_transform rescaled the map
        self.last_transform = None    # (s, R, t) of the latest world transform
        self.viba1_done = False
        self.viba2_done = False
        self.bad_imu = False  # mbBadImu (consumed by the system/tracker)
        self.abort_gba = False  # mbStopGBA (request_abort_gba)
        # True when this mapper runs on a background thread SHARING the device
        # stream with a latency-critical tracker (system.async_mapping): long
        # optimizations are then dispatched in short bites with a stream yield
        # between them, so per-frame tracking programs interleave instead of
        # queueing behind one ~80 ms BA dispatch.
        self.share_stream = False
        # qsize probe of the async KF queue (system wires it): local BA
        # aborts at a bite boundary when a NEW keyframe is waiting — the
        # reference's mbAbortBA (LocalMapping.cc:104 InsertKeyFrame sets it,
        # Optimizer::LocalBundleAdjustment polls pbStopFlag). Keeps the
        # mapper current at high frame rates instead of polishing a stale
        # window while the queue grows.
        self.queue_probe = None
        self.last_scale_refine_t = -1e18  # ScaleRefinement cadence clock
        self._imu_init_failures = 0
        self._staging_map = 0  # map id the viba1/viba2/t_imu_init clocks track
        # mTinit (LocalMapping.cc:180-188): accumulated time spent IN MOTION
        # since IMU init — each keyframe whose last two gaps moved > 5 cm
        # adds its gap time. Gates the excitation watchdog and VIBA staging.
        self.t_init_accum = 0.0
        self._t_accum_by_map: dict[int, float] = {}  # per-map mTinit store
        self._last_motion_kf = -1

    # ------------------------------------------------------------------ main
    def process_keyframe(self, kf: int):
        from ..utils.profiling import GLOBAL_TIMER as T
        with T.stage("mp_cull"):
            self.cull_map_points(kf)
        with T.stage("mp_create"):
            self.create_new_points(kf)
        with T.stage("fuse"):
            self.fuse_neighbors(kf)
        if len(self.map.kf_ids()) > 2:
            with T.stage("local_ba"):
                self.local_ba(kf)
        if self.imu is not None:
            self.maybe_initialize_imu(kf)
        with T.stage("kf_cull"):
            self.cull_keyframes(kf)

    def _merge_preintegrations(self, kf: int):
        """Preintegrated::MergePrevious (ImuTypes.cc:329): when a keyframe in
        the temporal chain is culled, re-preintegrate its successor's window
        from the concatenated raw samples."""
        import jax.numpy as jnp
        from ..optim import imu as imu_mod
        m = self.map
        nxt = int(m.kf_next[kf])
        cur = self.kf_preint.get(kf)
        after = self.kf_preint.get(nxt) if nxt >= 0 else None
        if cur is None or after is None:
            self.kf_preint.pop(kf, None)
            return
        acc = jnp.concatenate([cur.acc, after.acc])
        gyr = jnp.concatenate([cur.gyr, after.gyr])
        dts = jnp.concatenate([cur.dts, after.dts])
        # keep active samples first, then shrink to the power-of-two bucket
        # that holds ALL of them (both windows can be full)
        order = jnp.argsort(~(dts > 0))
        n_active = int(np.asarray((dts > 0).sum()))
        cap = 32
        while cap < n_active:
            cap *= 2
        self.kf_preint[nxt] = imu_mod.preintegrate(
            acc[order][:cap], gyr[order][:cap], dts[order][:cap],
            after.bias, self.imu.calib,
        )
        self.kf_preint.pop(kf, None)

    # ------------------------------------------------------------- IMU init
    def _temporal_chain(self, kf: int, cap: int = 32) -> list[int]:
        chain = []
        k = kf
        m = self.map
        while k >= 0 and len(chain) < cap and m.kf_valid[k]:
            chain.append(int(k))
            k = int(m.kf_prev[k])
        chain.reverse()
        return chain

    def _build_inertial_window(self, chain):
        """Body states from camera poses (Twb = Twc * Tcb) + stacked
        preintegrations along the temporal chain."""
        m = self.map
        import jax.numpy as jnp
        Rbc = np.asarray(self.imu.calib.Rbc)
        tbc = np.asarray(self.imu.calib.tbc)
        Rwb, pwb = [], []
        for k in chain:
            Rwc = m.kf_R[k].T
            cw = -Rwc @ m.kf_t[k]
            Rwb.append(Rwc @ Rbc.T)          # Rwb = Rwc * Rcb
            pwb.append(cw - Rwb[-1] @ tbc)   # pwb = cw - Rwb tbc
        Rwb = np.stack(Rwb).astype(np.float32)
        pwb = np.stack(pwb).astype(np.float32)
        pres = []
        for k in chain[1:]:
            p = self.kf_preint.get(k)
            if p is None:
                return None
            pres.append(p)
        pre_stack = _stack_preints(pres)
        dt = np.diff(m.kf_time[chain])
        vel0 = np.zeros_like(pwb)
        vel0[1:] = np.diff(pwb, axis=0) / np.maximum(dt[:, None], 1e-3)
        vel0[0] = vel0[1]
        return inertial.InertialWindow(
            Rwb=jnp.asarray(Rwb), pwb=jnp.asarray(pwb),
            vel0=jnp.asarray(vel0), pre=pre_stack,
            valid=jnp.ones(len(chain) - 1, bool),
        )

    def maybe_initialize_imu(self, kf: int):
        """InitializeIMU staging (LocalMapping.cc:1539 + A.5 schedule):
        stage 1 gravity/scale/bias init, then VIBA1 (>5 s) and VIBA2 (>15 s)
        refinements with tighter priors."""
        m = self.map
        mid = m.active_map
        if mid != self._staging_map:
            # active map changed (sub-map spawn after loss, or a merge):
            # re-seat the staging clocks on the new map's recorded stages
            # park the old map's motion clock, restore the new one's (mTinit
            # is per-map state in the reference)
            self._t_accum_by_map[self._staging_map] = self.t_init_accum
            self._staging_map = mid
            self.viba1_done = m.map_viba1.get(mid, False)
            self.viba2_done = m.map_viba2.get(mid, False)
            self.t_imu_init = None
            self.t_init_accum = self._t_accum_by_map.get(mid, 0.0)
            self._imu_init_failures = 0
        chain = self._temporal_chain(kf)
        if len(chain) < 6:
            return
        t_now = m.kf_time[kf]
        initialized = m.map_imu_init.get(mid, False)
        mono = self.cfg.is_mono

        if not initialized:
            span = m.kf_time[chain[-1]] - m.kf_time[chain[0]]
            if span < (2.0 if mono else 1.0) or len(chain) < 8:
                return
            win = self._build_inertial_window(chain)
            if win is None:
                return
            Rwg, s, bias, vel, _ = inertial.inertial_init(
                win, prior_g=1e2, prior_a=1e10 if mono else 1e5,
                optimize_scale=mono,
            )
            s = float(s)
            if s < 0.1:
                # insufficient excitation (LocalMapping.cc:1680); after
                # repeated failures flag bad IMU so the tracker can reset the
                # active map (mbBadImu, LocalMapping.cc:189-199)
                self._imu_init_failures += 1
                if self._imu_init_failures > 10:
                    self.bad_imu = True
                return
            # record velocities in the CURRENT (visual) frame, then gravity-
            # align + rescale the whole map (Map::ApplyScaledRotation):
            # world' = s * Rwg^T * world  => gravity becomes -z, scale metric
            for i, k in enumerate(chain):
                m.kf_vel[k] = np.asarray(vel[i])
                m.kf_bias[k] = np.asarray(bias)
            Rgw = np.asarray(Rwg).T
            m.apply_transform(mid, s, Rgw, np.zeros(3, np.float32))
            self.map_transformed = True
            self.last_transform = (s, Rgw, np.zeros(3, np.float32))
            self.imu.bias = np.asarray(bias)
            m.map_imu_init[mid] = True
            self.t_imu_init = float(t_now)
            # a FRESH init (including after a bad-init map reset) restarts
            # the refinement ladder from stage VIBA1
            self.viba1_done = False
            self.viba2_done = False
            m.map_viba1[mid] = False
            m.map_viba2[mid] = False
            # FullInertialBA over the init window (Optimizer.cc:3254, 100 it
            # in the reference; the windowed VI-BA converges in ~12 here)
            pts = m.local_point_ids(chain, self.cfg.local_ba_points)
            self._run_vi_ba(chain, pts, iters=12)
            return

        # refinement stages
        if self.t_imu_init is None:
            self.t_imu_init = float(t_now)
        # mTinit semantics (LocalMapping.cc:180-199): time is accumulated
        # only while MOVING (last two KF gaps > 5 cm total), and a still map
        # that hasn't accumulated 10 s of motion is reset — scale/velocity
        # were unobservable, the init is garbage. Wall-clock staging would
        # disarm the watchdog during long hovers and stage VIBA too early.
        if len(chain) >= 3 and chain[-1] != self._last_motion_kf:
            self._last_motion_kf = chain[-1]
            recent = chain[-3:]
            dist = 0.0
            for a, b in zip(recent[:-1], recent[1:]):
                ca = -m.kf_R[a].T @ m.kf_t[a]
                cb = -m.kf_R[b].T @ m.kf_t[b]
                dist += float(np.linalg.norm(cb - ca))
            if dist > 0.05:
                self.t_init_accum += float(
                    m.kf_time[chain[-1]] - m.kf_time[chain[-2]]
                )
            if dist < 0.02 and self.t_init_accum < 10.0 and not self.viba2_done:
                self.bad_imu = True
                return
        elapsed = self.t_init_accum
        stage = None
        if not self.viba1_done and elapsed > 5.0:
            stage = (1.0, 1e5)
        elif self.viba1_done and not self.viba2_done and elapsed > 15.0:
            stage = (0.0, 0.0)
        if stage is None:
            # mono-only periodic scale/gravity refinement (ScaleRefinement,
            # LocalMapping.cc:1912; every ~10 s while the map is young)
            if (
                mono
                and elapsed > 25.0
                and float(t_now) - self.last_scale_refine_t > 10.0
                and len(m.kf_ids()) <= 200
            ):
                win = self._build_inertial_window(chain)
                if win is not None:
                    import jax.numpy as jnp
                    Rwg, s = inertial.scale_gravity_refine(
                        win, jnp.asarray(self.imu.bias)
                    )
                    s = float(s)
                    if abs(s - 1.0) > 0.002 and 0.5 < s < 2.0:
                        Rgw = np.asarray(Rwg).T
                        m.apply_transform(mid, s, Rgw, np.zeros(3, np.float32))
                        self.map_transformed = True
                        self.last_transform = (s, Rgw, np.zeros(3, np.float32))
                    self.last_scale_refine_t = float(t_now)
            return
        win = self._build_inertial_window(chain)
        if win is None:
            return
        Rwg, s, bias, vel, _ = inertial.inertial_init(
            win, prior_g=stage[0], prior_a=stage[1], optimize_scale=False,
        )
        for i, k in enumerate(chain):
            m.kf_vel[k] = np.asarray(vel[i])
            m.kf_bias[k] = np.asarray(bias)
        self.imu.bias = np.asarray(bias)
        if not self.viba1_done:
            self.viba1_done = True
            m.map_viba1[mid] = True
        else:
            self.viba2_done = True
            m.map_viba2[mid] = True
        pts = m.local_point_ids(chain, self.cfg.local_ba_points)
        self._run_vi_ba(chain, pts, iters=8)

    # ------------------------------------------------------------- cull MPs
    def cull_map_points(self, current_kf: int):
        """MapPointCulling (LocalMapping.cc:471): kill low found-ratio or
        under-observed young points; graduate survivors after 3 KFs."""
        m = self.map
        keep = []
        for mp, birth in self.recent_mps:
            if not m.mp_valid[mp]:
                continue
            age = current_kf - birth
            ratio = m.mp_found[mp] / max(m.mp_visible[mp], 1.0)
            if ratio < self.cfg.mp_cull_found_ratio:
                m.remove_point(mp)
            elif age >= 2 and m.mp_n_obs[mp] <= 2:
                m.remove_point(mp)
            elif age >= 3:
                continue  # graduated
            else:
                keep.append((mp, birth))
        self.recent_mps = keep

    # ------------------------------------------------------ new points (tri)
    def create_new_points(self, kf: int):
        """CreateNewMapPoints (LocalMapping.cc:526): for each covisible
        neighbor, epipolar-match unassociated features and triangulate."""
        m = self.map
        cfg = self.cfg
        neighbors = m.covisible_kfs(kf, k=cfg.triangulation_neighbors, min_weight=5)
        if not neighbors:
            return
        R1, t1 = m.kf_R[kf], m.kf_t[kf]
        c1 = -R1.T @ t1

        # baseline gate per neighbor (mono: baseline/medianDepth > 0.01)
        usable = []
        for nb in neighbors:
            R2, t2 = m.kf_R[nb], m.kf_t[nb]
            c2 = -R2.T @ t2
            baseline = np.linalg.norm(c1 - c2)
            mids = m.kf_feat_mp[nb]
            mp_ids = mids[mids >= 0]
            if len(mp_ids) == 0:
                continue
            depths = (m.mp_pos[mp_ids] @ R2.T + t2)[:, 2]
            med_depth = float(np.median(depths)) if len(depths) else 1.0
            if baseline / max(med_depth, 1e-6) >= 0.01:
                usable.append(nb)
        if not usable:
            return

        # ONE device program for all neighbors (padded to the static cap)
        B = cfg.triangulation_neighbors
        usable = usable[:B]
        nbs = (usable + [usable[-1]] * B)[:B]
        active = np.zeros(B, bool)
        active[: len(usable)] = True
        nbs_arr = np.asarray(nbs)
        free1 = m.kf_feat_valid[kf] & (m.kf_feat_mp[kf] < 0)
        free2s = m.kf_feat_valid[nbs_arr] & (m.kf_feat_mp[nbs_arr] < 0)
        free2s[~active] = False
        idxs, Xs, goods = programs.map_new_points_multi(
            self.cam,
            jnp.asarray(m.kf_feat_desc[kf]), jnp.asarray(m.kf_feat_xy[kf]),
            jnp.asarray(m.kf_feat_level[kf]), jnp.asarray(m.kf_feat_ur[kf]),
            jnp.asarray(free1),
            jnp.asarray(R1), jnp.asarray(t1),
            jnp.asarray(m.kf_feat_desc[nbs_arr]),
            jnp.asarray(m.kf_feat_xy[nbs_arr]),
            jnp.asarray(m.kf_feat_level[nbs_arr]),
            jnp.asarray(m.kf_feat_ur[nbs_arr]),
            jnp.asarray(free2s),
            jnp.asarray(m.kf_R[nbs_arr]), jnp.asarray(m.kf_t[nbs_arr]),
            scale=cfg.scale_factor,
        )
        idxs, Xs, goods = device_fetch((idxs, Xs, goods))
        claimed = np.zeros(m.cfg.n_feat, bool)  # one new point per feature
        all_new = []
        for b, nb in enumerate(usable):
            good_np = goods[b] & ~claimed
            gi = np.nonzero(good_np)[0]
            if len(gi) == 0:
                continue
            claimed[gi] = True
            ids = m.add_map_points(Xs[b][gi], m.kf_feat_desc[kf][gi], kf, gi)
            got = np.nonzero(ids >= 0)[0]
            m.add_observations(ids[got], int(nb), idxs[b][gi[got]])
            for mp in ids[got]:
                self.recent_mps.append((int(mp), kf))
            all_new.extend(int(x) for x in ids[got])
        if all_new:
            m.update_point_geometry(np.asarray(all_new))

    # ----------------------------------------------------------------- fuse
    def fuse_neighbors(self, kf: int):
        """SearchInNeighbors (LocalMapping.cc:939): project current KF's
        points into neighbors and fuse duplicates."""
        m = self.map
        neighbors = m.covisible_kfs(kf, k=self.cfg.triangulation_neighbors, min_weight=5)
        mids = m.kf_feat_mp[kf]
        ids = mids[mids >= 0]
        if len(ids) == 0 or not neighbors:
            return
        cap = self.cfg.local_points_cap
        ids = ids[:cap]
        L = cap
        lp = programs.LocalPoints(
            pos=jnp.asarray(_pad_rows(m.mp_pos[ids], L)),
            desc=jnp.asarray(_pad_rows(m.mp_desc[ids], L)),
            normal=jnp.asarray(_pad_rows(m.mp_normal[ids], L)),
            min_dist=jnp.asarray(_pad_rows(m.mp_min_dist[ids], L)),
            max_dist=jnp.asarray(_pad_rows(m.mp_max_dist[ids], L)),
            valid=jnp.asarray(_pad_rows(np.ones(len(ids), bool), L)),
            angle=jnp.asarray(_pad_rows(m.mp_angle[ids], L)),
        )
        B = self.cfg.triangulation_neighbors
        nbs = (neighbors + [neighbors[-1]] * B)[:B]
        active = np.zeros(B, bool)
        active[: min(len(neighbors), B)] = True
        nbs_arr = np.asarray(nbs)
        valids = m.kf_feat_valid[nbs_arr].copy()
        valids[~active] = False
        fidxs, oks, exs = programs.fuse_project_multi(
            self.cam,
            jnp.asarray(m.kf_R[nbs_arr]), jnp.asarray(m.kf_t[nbs_arr]), lp,
            jnp.asarray(m.kf_feat_xy[nbs_arr]), jnp.asarray(m.kf_feat_level[nbs_arr]),
            jnp.asarray(m.kf_feat_desc[nbs_arr]), jnp.asarray(valids),
            jnp.asarray(m.kf_feat_mp[nbs_arr]),
            n_levels=self.cfg.n_levels, scale=self.cfg.scale_factor,
        )
        fidxs, oks, exs = device_fetch((fidxs, oks, exs))
        idv = np.asarray(ids)
        for b, nb in enumerate(neighbors[:B]):
            fidx = fidxs[b]
            ok_np = oks[b][: len(ids)]
            ex = exs[b][: len(ids)]
            # duplicates first (rare): keep the point with more observations
            for j in np.nonzero(ok_np & (ex >= 0) & (ex != idv))[0]:
                mp, e = int(idv[j]), int(ex[j])
                if m.mp_valid[mp] and m.mp_valid[e]:
                    if m.mp_n_obs[mp] >= m.mp_n_obs[e]:
                        m.replace_point(e, mp)
                    else:
                        m.replace_point(mp, e)
            # then batch the plain extensions into the neighbor
            add = np.nonzero(ok_np & (ex < 0) & m.mp_valid[idv])[0]
            m.add_observations(idv[add], int(nb), fidx[add])
        m.update_point_geometry(ids)

    # ------------------------------------------------------------- local BA
    def local_ba(self, kf: int):
        """LocalBundleAdjustment (Optimizer.cc:1758) — or, once the map is
        IMU-initialized, LocalInertialBA over the temporal sliding window
        (Optimizer.cc:2221, <=10 KFs)."""
        m = self.map
        cfg = self.cfg
        if self.imu is not None and m.map_imu_init.get(m.active_map, False):
            chain = self._temporal_chain(kf, cap=cfg.local_ba_kfs)
            if len(chain) >= 3:
                pts = m.local_point_ids(chain, cfg.local_ba_points)
                self._run_vi_ba(chain, pts,
                                iters=max(4, cfg.local_ba_iters // 2),
                                abortable=True)
                return
        opt_kfs = [kf] + m.covisible_kfs(kf, k=cfg.local_ba_kfs - 1, min_weight=5)
        pts = m.local_point_ids(opt_kfs, cfg.local_ba_points)
        self._run_ba(opt_kfs, pts, cfg.local_ba_iters, abortable=True)

    def full_inertial_ba(self, iters: int = 7, max_kfs: int = 256,
                         point_cap: int | None = None):
        """WHOLE-MAP FullInertialBA (Optimizer.cc:3254): every keyframe of the
        active map's temporal chain + ALL its landmarks, first KF's pose fixed
        (velocities/biases everywhere free). The reference runs this with
        100 iters at IMU init and 7 iters as the inertial GBA after loops
        (maps < 200 KFs, LoopClosing.cc:1669-1681). Runs in abortable 2-3
        iteration bites — each bite re-snapshots under the map lock and
        writes back, so it can race the front end like the visual GBA and
        stop at a bite boundary on request_abort_gba. Problems past the dense
        solver's comfortable size switch to the point-chunked whole-map
        VI solver (vi_ba.vi_bundle_adjust_chunked) so no landmark is ever
        silently excluded."""
        m = self.map
        self.abort_gba = False
        newest = m.kf_ids()
        if len(newest) < 4:
            return
        chain = self._temporal_chain(int(newest[-1]), cap=max_kfs)
        if len(chain) < 4:
            return
        dense_cap = 4 * self.cfg.local_ba_points
        done = 0
        while done < iters and not self.abort_gba:
            bite = min(3, iters - done)
            pts = m.local_point_ids(chain, point_cap)
            if len(pts) > dense_cap:
                self._run_vi_ba(chain, pts, iters=bite, chunked=True)
            else:
                self._run_vi_ba(chain, pts, iters=bite, point_cap=dense_cap)
            done += bite

    def _run_vi_ba(self, chain, pts, iters: int, seam=(), abortable=False,
                   point_cap: int | None = None, chunked: bool = False):
        """Build + solve a visual-inertial BA over the temporal chain; first
        KF's pose fixed. Links without a preintegration — and links listed in
        `seam` (cross-map welds, where the stored preintegration belongs to a
        different predecessor) — carry no inertial factor (pre_valid=False);
        the chain is then tied together by the shared visual observations.
        chunked=True routes through the point-chunked whole-map solver (no
        point-count ceiling; P padded to a chunk multiple)."""
        import jax
        import jax.numpy as jnp
        from ..optim import vi_ba, imu as imu_mod

        m = self.map
        if len(pts) < 8:
            return
        pre_ok = np.ones(len(chain) - 1, bool)
        pres = []
        for j, k in enumerate(chain[1:]):
            p_ = self.kf_preint.get(k)
            if p_ is None or j in seam:
                pre_ok[j] = False
                p_ = imu_mod.empty_preintegrated(1)
            pres.append(p_)
        if not pre_ok.any():
            return
        pre_stack = _stack_preints(pres)

        K = len(chain)
        Rbc = np.asarray(self.imu.calib.Rbc)
        tbc = np.asarray(self.imu.calib.tbc)
        Rcb = Rbc.T
        tcb = -Rcb @ tbc
        Rwb = np.zeros((K, 3, 3), np.float32)
        pwb = np.zeros((K, 3), np.float32)
        if chunked:
            VI_CHUNK = 2048
            P = max(VI_CHUNK, -(-len(pts) // VI_CHUNK) * VI_CHUNK)
        else:
            P = _pad_pow2(len(pts), 256, point_cap or self.cfg.local_ba_points)
        slot = {c: i for i, c in enumerate(chain)}
        p_arr = np.zeros((P, 3), np.float32)
        p_valid = np.zeros((P,), bool)
        with m.lock:  # consistent problem snapshot vs the tracker's inserts
            for i, k in enumerate(chain):
                Rwc = m.kf_R[k].T
                cw = -Rwc @ m.kf_t[k]
                Rwb[i] = Rwc @ Rbc.T
                pwb[i] = cw - Rwb[i] @ tbc
            p_arr[: len(pts)] = m.mp_pos[pts]
            p_valid[: len(pts)] = True
            (obs_cam, obs_uv, obs_ur, obs_level, obs_valid,
             obs_rig, rig_R, rig_t) = _build_obs_tables(m, pts, slot, P)
            vel0 = m.kf_vel[chain].copy()
            bias0 = m.kf_bias[chain].copy()

        prob = vi_ba.VIBAProblem(
            Rwb=jnp.asarray(Rwb), pwb=jnp.asarray(pwb),
            vel=jnp.asarray(vel0), bias=jnp.asarray(bias0),
            fixed=jnp.arange(K) < 1,
            Rcb=jnp.asarray(Rcb.astype(np.float32)),
            tcb=jnp.asarray(tcb.astype(np.float32)),
            p=jnp.asarray(p_arr), p_valid=jnp.asarray(p_valid),
            obs_cam=jnp.asarray(obs_cam), obs_uv=jnp.asarray(obs_uv),
            obs_ur=jnp.asarray(obs_ur), obs_level=jnp.asarray(obs_level),
            obs_valid=jnp.asarray(obs_valid),
            pre=pre_stack, pre_valid=jnp.asarray(pre_ok),
            obs_rig=None if obs_rig is None else jnp.asarray(obs_rig),
            rig_R=None if rig_R is None else jnp.asarray(rig_R),
            rig_t=None if rig_t is None else jnp.asarray(rig_t),
        )
        abort_probe = self.queue_probe if abortable else None
        if chunked or ((self.share_stream or abort_probe is not None)
                       and iters > 2):
            # bite-wise lam-threaded dispatch: stream yields + mbAbortBA at
            # bite boundaries (see _run_ba). chunked problems always go
            # through this path, via the point-chunked whole-map solver.
            import jax
            lam = jnp.asarray(1e-4, jnp.float32)
            Rwb_n, pwb_n = prob.Rwb, prob.pwb
            vel_n, bias_n, p_n = prob.vel, prob.bias, prob.p
            done = 0
            while done < iters:
                bite = min(2, iters - done)
                probd = prob._replace(
                    Rwb=Rwb_n, pwb=pwb_n, vel=vel_n, bias=bias_n, p=p_n
                )
                if chunked:
                    Rwb_n, pwb_n, vel_n, bias_n, p_n, lam = (
                        vi_ba.vi_bundle_adjust_chunked(
                            self.cam, probd, lam, iters=bite,
                            point_chunk=VI_CHUNK)
                    )
                else:
                    Rwb_n, pwb_n, vel_n, bias_n, p_n, lam = (
                        vi_ba.vi_bundle_adjust_step(
                            self.cam, probd, lam, iters=bite)
                    )
                done += bite
                if (abort_probe is not None and done >= 2
                        and abort_probe() > 0):
                    break  # mbAbortBA
                if done < iters and self.share_stream:
                    _bite_yield()
        else:
            Rwb_n, pwb_n, vel_n, bias_n, p_n, inlier, _ = vi_ba.vi_bundle_adjust(
                self.cam, prob, iters=iters
            )
        Rwb_n, pwb_n, vel_n, bias_n, p_n = device_fetch(
            (Rwb_n, pwb_n, vel_n, bias_n, p_n)
        )
        with m.lock:  # atomic write-back vs the tracker's local-view reads
            for i, k in enumerate(chain):
                Rwc = Rwb_n[i] @ Rbc          # Rwb * Rbc
                Rcw = Rwc.T
                cw = pwb_n[i] + Rwb_n[i] @ tbc
                m.kf_R[k] = Rcw
                m.kf_t[k] = -Rcw @ cw
                m.kf_vel[k] = vel_n[i]
                m.kf_bias[k] = bias_n[i]
            m.mp_pos[pts] = p_n[: len(pts)]
            self.imu.bias = bias_n[-1]
            m.version += 1

    def merge_inertial_ba(self, kf: int, cand: int):
        """MergeInertialBA (Optimizer.cc:6034): welding VI-BA over the union
        of the two welded maps' temporal chains. The seam link between the
        old-map chain and the current chain carries no preintegration (the
        maps come from different tracking episodes), so its inertial factor
        is masked and the fused weld-window points tie the chains together
        visually. Gauge: first KF of the old chain stays fixed."""
        m = self.map
        chain_a = self._temporal_chain(cand, cap=10)
        in_a = set(chain_a)
        chain_b = [k for k in self._temporal_chain(kf, cap=10) if k not in in_a]
        if not chain_b or len(chain_a) + len(chain_b) < 4:
            return
        chain = chain_a + chain_b
        pts = m.local_point_ids(chain, self.cfg.local_ba_points)
        self._run_vi_ba(chain, pts, iters=8, seam={len(chain_a) - 1})

    def global_ba(self, iters: int = 10):
        """GlobalBundleAdjustemnt (Optimizer.cc:2831): ALL keyframes and
        points of the active map, first KF fixed. Small maps go through the
        dense windowed solver in one dispatch; larger maps use the chunked
        full-map path with abort checks between LM bites and spanning-tree
        propagation to keyframes/points created while the BA ran
        (RunGlobalBundleAdjustment, LoopClosing.cc:3067-3321)."""
        m = self.map
        kfs = [int(k) for k in m.kf_ids()]
        pts = m.local_point_ids(kfs, cap=10 ** 9)
        if (self._dba_mesh() is None and len(kfs) <= 128
                and len(pts) <= self.cfg.local_ba_points):
            self._run_ba(kfs, pts, iters, gauge_fix_first=True)
            return
        self.abort_gba = False  # a fresh GBA clears any stale stop request
        self.run_full_map_ba(kfs, pts, iters)

    def _dba_mesh(self):
        """Device mesh for DISTRIBUTED full-map BA, or None. Controlled by
        cfg.dba_devices (0 = off, -1 = all local devices, N = first N); the
        mesh needs >= 2 devices to be worth a shard_map dispatch. This is
        the live-pipeline entry to parallel.dba (SURVEY §2.3 P6, §5.8) —
        the GBA thread and loop-closure GBA route through run_full_map_ba
        and pick it up automatically."""
        n = getattr(self.cfg, "dba_devices", 0)
        if n == 0:
            return None
        import jax
        from jax.sharding import Mesh

        devs = jax.devices()
        if n < 0:
            n = len(devs)
        n = min(n, len(devs))
        if n < 2:
            return None
        return Mesh(np.array(devs[:n]), ("mp",))

    def request_abort_gba(self):
        """mbStopGBA (LoopClosing.cc:1669): the running full-map BA stops at
        the next LM-bite boundary; partial progress is still written back."""
        self.abort_gba = True

    def run_full_map_ba(self, kfs: list[int], pts, iters: int = 10):
        """Chunked full-map BA (optim/ba.py bundle_adjust_resumable). The LM
        loop is dispatched in bites of 2 iterations with an abort check
        between bites; after convergence the correction is propagated through
        the spanning tree to keyframes inserted during the run and to their
        new map points (LoopClosing.cc:3170-3260)."""
        import jax.numpy as jnp
        from ..optim import ba

        m = self.map
        cfg = self.cfg
        snap_set = set(kfs)
        pts = np.asarray(pts)
        if len(pts) < 8 or len(kfs) < 3:
            return

        anchor = min(kfs)
        opt_kfs = [k for k in kfs if k != anchor]
        cam_ids = opt_kfs + [anchor]
        cam_slot = {c: i for i, c in enumerate(cam_ids)}
        K = _pad_pow2(len(cam_ids), 32, 1 << 16)
        CHUNK = 2048
        mesh = self._dba_mesh()
        P = -(-len(pts) // CHUNK) * CHUNK
        if mesh is not None:  # landmark shards must divide P evenly
            n_dev = int(mesh.devices.size)
            P = -(-P // n_dev) * n_dev
        D = m.cfg.obs_cap

        cam_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        cam_t = np.zeros((K, 3), np.float32)
        cam_fixed = np.ones((K,), bool)
        p = np.zeros((P, 3), np.float32)
        p_valid = np.zeros((P,), bool)
        with m.lock:  # consistent problem snapshot vs the tracker's inserts
            for c, i in cam_slot.items():
                cam_R[i] = m.kf_R[c]
                cam_t[i] = m.kf_t[c]
            cam_fixed[: len(opt_kfs)] = False
            p[: len(pts)] = m.mp_pos[pts]
            p_valid[: len(pts)] = True
            (obs_cam, obs_uv, obs_ur, obs_level, obs_valid,
             obs_rig, rig_R, rig_t) = _build_obs_tables(m, pts, cam_slot, P)
        prob = ba.BAProblem(
            cam_R=jnp.asarray(cam_R), cam_t=jnp.asarray(cam_t),
            cam_fixed=jnp.asarray(cam_fixed),
            p=jnp.asarray(p), p_valid=jnp.asarray(p_valid),
            obs_cam=jnp.asarray(obs_cam), obs_uv=jnp.asarray(obs_uv),
            obs_ur=jnp.asarray(obs_ur), obs_level=jnp.asarray(obs_level),
            obs_valid=jnp.asarray(obs_valid),
            obs_rig=None if obs_rig is None else jnp.asarray(obs_rig),
            rig_R=None if rig_R is None else jnp.asarray(rig_R),
            rig_t=None if rig_t is None else jnp.asarray(rig_t),
        )

        if mesh is not None:
            # distributed GBA (SURVEY §2.3 P6, §5.8): landmark-sharded psum
            # BA over the device mesh, dispatched in the same abortable
            # lam-threaded bites as the single-device path
            from ..parallel import dba as dba_mod

            sharded = dba_mod.shard_problem(prob, mesh)
            Rj, tj, pj = sharded.cam_R, sharded.cam_t, sharded.p
            lam = jnp.asarray(1e-4, prob.p.dtype)
            inlier = None
            done = 0
            while done < iters and not self.abort_gba:
                bite = min(2, iters - done)
                Rj, tj, pj, inlier, _cost, lam = dba_mod.bundle_adjust_sharded(
                    self.cam, sharded._replace(cam_R=Rj, cam_t=tj, p=pj),
                    mesh, iters=bite, lam0=lam,
                )
                done += bite
            if inlier is None:  # aborted before the first bite
                inlier = ba.classify_observations(
                    self.cam, prob._replace(cam_R=Rj, cam_t=tj, p=pj))
            Rn, tn, pn, inlier = device_fetch((Rj, tj, pj, inlier))
        else:
            Rj, tj, pj = prob.cam_R, prob.cam_t, prob.p
            lam = jnp.asarray(1e-4, prob.p.dtype)
            done = 0
            while done < iters and not self.abort_gba:
                bite = min(2, iters - done)
                Rj, tj, pj, lam = ba.bundle_adjust_resumable(
                    self.cam, prob._replace(cam_R=Rj, cam_t=tj, p=pj), lam,
                    iters=bite, point_chunk=CHUNK,
                )
                done += bite
            inlier = ba.classify_observations(
                self.cam, prob._replace(cam_R=Rj, cam_t=tj, p=pj)
            )
            Rn, tn, pn, inlier = device_fetch((Rj, tj, pj, inlier))

        # ---- write-back + propagation to work created during the BA ----
        # one atomic section: poses + points + spanning-tree propagation must
        # land together or the tracker could read a half-corrected map
        with m.lock:
            pre_R = m.kf_R.copy()
            pre_t = m.kf_t.copy()
            for c in opt_kfs:
                i = cam_slot[c]
                m.kf_R[c] = Rn[i]
                m.kf_t[c] = tn[i]
            m.mp_pos[pts] = pn[: len(pts)]
            # spanning-tree correction of keyframes inserted during the BA:
            # T_new(child) = T_old(child) * T_old(parent)^-1 * T_new(parent)
            # (ids increase monotonically, so parents are always processed first)
            for k in m.kf_ids():
                k = int(k)
                if k in snap_set:
                    continue
                par = int(m.kf_parent[k])
                if par < 0:
                    continue
                dR = pre_R[k] @ pre_R[par].T
                dt = pre_t[k] - dR @ pre_t[par]
                m.kf_R[k] = (dR @ m.kf_R[par]).astype(np.float32)
                m.kf_t[k] = (dR @ m.kf_t[par] + dt).astype(np.float32)
            # points born during the BA: correct through their reference KF
            all_pts = m.mp_ids()
            new_pts = np.asarray(all_pts)[~np.isin(all_pts, pts)]
            if len(new_pts):
                ref = m.mp_first_kf[new_pts]
                ok = ref >= 0
                new_pts, ref = new_pts[ok], ref[ok]
                pc = (
                    np.einsum("kij,kj->ki", pre_R[ref], m.mp_pos[new_pts])
                    + pre_t[ref]
                )
                m.mp_pos[new_pts] = np.einsum(
                    "kji,kj->ki", m.kf_R[ref], pc - m.kf_t[ref]
                ).astype(np.float32)
            # outlier erase (Optimizer.cc:2100-2160 post-pass)
            bad = np.argwhere(obs_valid[: len(pts)] & ~inlier[: len(pts)])
            for j, srow in bad:
                if srow >= D:  # right-camera obs: drop just the rig row
                    m.mp_obs_r_level[pts[j], srow - D] = -1
                    continue
                c = m.mp_obs_kf[pts[j], srow]
                if c >= 0:
                    m.remove_observation(int(pts[j]), int(c))
            m.version += 1

    def _run_ba(self, opt_kfs, pts, iters: int, gauge_fix_first: bool = False,
                abortable: bool = False):
        m = self.map
        cfg = self.cfg
        opt_kfs = list(dict.fromkeys(int(k) for k in opt_kfs))
        opt_set = set(opt_kfs)
        if len(pts) < 8:
            return
        # fixed observers
        fixed = []
        obs_kfs = np.unique(m.mp_obs_kf[pts])
        for k in obs_kfs:
            if k >= 0 and int(k) not in opt_set:
                fixed.append(int(k))
        fixed = fixed[: cfg.local_ba_fixed_cap]
        # gauge-fix: pin the oldest KF when nothing else anchors the window
        if gauge_fix_first or not fixed:
            anchor = min(opt_kfs)
            fixed = [anchor] + fixed
            opt_kfs = [k for k in opt_kfs if k != anchor]
        cam_ids = opt_kfs + fixed
        cam_slot = {c: i for i, c in enumerate(cam_ids)}
        K = _pad_pow2(len(cam_ids), 8, 256)
        P = _pad_pow2(len(pts), 256, cfg.local_ba_points)
        D = m.cfg.obs_cap

        cam_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        cam_t = np.zeros((K, 3), np.float32)
        cam_fixed = np.ones((K,), bool)
        p = np.zeros((P, 3), np.float32)
        p_valid = np.zeros((P,), bool)
        with m.lock:  # consistent problem snapshot vs the tracker's inserts
            for c, i in cam_slot.items():
                cam_R[i] = m.kf_R[c]
                cam_t[i] = m.kf_t[c]
                cam_fixed[i] = c in fixed or c not in opt_set
            cam_fixed[: len(opt_kfs)] = False
            p[: len(pts)] = m.mp_pos[pts]
            p_valid[: len(pts)] = True
            (obs_cam, obs_uv, obs_ur, obs_level, obs_valid,
             obs_rig, rig_R, rig_t) = _build_obs_tables(m, pts, cam_slot, P)

        prob = ba.BAProblem(
            cam_R=jnp.asarray(cam_R), cam_t=jnp.asarray(cam_t),
            cam_fixed=jnp.asarray(cam_fixed),
            p=jnp.asarray(p), p_valid=jnp.asarray(p_valid),
            obs_cam=jnp.asarray(obs_cam), obs_uv=jnp.asarray(obs_uv),
            obs_ur=jnp.asarray(obs_ur), obs_level=jnp.asarray(obs_level),
            obs_valid=jnp.asarray(obs_valid),
            obs_rig=None if obs_rig is None else jnp.asarray(obs_rig),
            rig_R=None if rig_R is None else jnp.asarray(rig_R),
            rig_t=None if rig_t is None else jnp.asarray(rig_t),
        )
        abort_probe = self.queue_probe if abortable else None
        if (self.share_stream or abort_probe is not None) and iters > 2:
            # bite-wise dispatch (bit-identical to the monolithic call when
            # it runs to completion), for two reference behaviors:
            #  * share_stream: yield the device stream between 2-iteration
            #    bites so the tracker's per-frame programs interleave with
            #    this BA instead of stalling behind it (single-chip analog
            #    of the reference's Tracking/LocalMapping preemption);
            #  * mbAbortBA: when a NEW keyframe is already queued, abandon
            #    the remaining iterations at a bite boundary and go process
            #    it (LocalMapping.cc:104, Optimizer.cc pbStopFlag).
            import jax
            lam = jnp.asarray(1e-4, jnp.float32)
            Rd, td, pd = prob.cam_R, prob.cam_t, prob.p
            done = 0
            while done < iters:
                bite = min(2, iters - done)
                probd = prob._replace(cam_R=Rd, cam_t=td, p=pd)
                Rd, td, pd, lam = ba.bundle_adjust_step(
                    self.cam, probd, lam, iters=bite
                )
                done += bite
                if (abort_probe is not None and done >= 2
                        and abort_probe() > 0):
                    break  # mbAbortBA: a fresher keyframe is waiting
                if done < iters and self.share_stream:
                    _bite_yield()
            probd = prob._replace(cam_R=Rd, cam_t=td, p=pd)
            inlier = ba.classify_observations(self.cam, probd)
            Rn, tn, pn, inlier = device_fetch((Rd, td, pd, inlier))
        else:
            Rn, tn, pn, inlier, _ = ba.bundle_adjust(self.cam, prob, iters=iters)
            Rn, tn, pn, inlier = device_fetch((Rn, tn, pn, inlier))
        with m.lock:  # atomic write-back vs the tracker's local-view reads
            for c in opt_kfs:
                i = cam_slot[c]
                m.kf_R[c] = Rn[i]
                m.kf_t[c] = tn[i]
            m.mp_pos[pts] = pn[: len(pts)]
            # erase outlier observations (Optimizer.cc:2100-2160 post-pass)
            bad = np.argwhere(obs_valid[: len(pts)] & ~inlier[: len(pts)])
            for j, srow in bad:
                if srow >= D:  # right-camera obs: drop just the rig row
                    m.mp_obs_r_level[pts[j], srow - D] = -1
                    continue
                c = m.mp_obs_kf[pts[j], srow]
                if c >= 0:
                    m.remove_observation(int(pts[j]), int(c))
            m.version += 1

    # ------------------------------------------------------------- cull KFs
    def cull_keyframes(self, kf: int):
        """KeyFrameCulling (LocalMapping.cc:1197): a covisible KF is redundant
        if >=90% of its points are seen by >=3 other KFs at same-or-finer
        octave."""
        m = self.map
        inertial = self.imu is not None
        if inertial and not m.map_imu_init.get(m.active_map, False):
            return  # protect the temporal chain until IMU init (LocalMapping.cc:1548)
        protected = set(self._temporal_chain(kf, cap=21)) if inertial else set()
        for cand in m.covisible_kfs(kf, k=10, min_weight=5):
            if cand == kf or not m.kf_valid[cand]:
                continue
            if m.kf_parent[cand] < 0:
                continue  # never cull the map-origin KF (GetInitKFid guard)
            if cand in protected:
                continue  # last Nd=21 temporal KFs protected (LocalMapping.cc:1197)
            mids = m.kf_feat_mp[cand]
            slots = np.nonzero(mids >= 0)[0]
            if len(slots) < 20:
                continue
            redundant = 0
            for fi in slots:
                mp = mids[fi]
                lvl = m.kf_feat_level[cand, fi]
                n_better = 0
                for s in range(m.cfg.obs_cap):
                    okf = m.mp_obs_kf[mp, s]
                    if okf < 0 or okf == cand:
                        continue
                    oi = m.mp_obs_idx[mp, s]
                    if m.kf_feat_level[okf, oi] <= lvl + 1:
                        n_better += 1
                if n_better >= 3:
                    redundant += 1
            if redundant > self.cfg.kf_cull_redundancy * len(slots):
                if inertial:
                    self._merge_preintegrations(cand)
                m.remove_keyframe(cand)
                if self.kfdb is not None:
                    self.kfdb.erase(cand)


def _stack_preints(pres):
    """Stack Preintegrated pytrees whose raw-sample buffers may have
    different power-of-two capacities (the IMU frontend grows buffers per
    keyframe gap): pad the raws to the common max, stack the rest directly.

    Leaves come from tracking-side jit programs and may be COMMITTED to the
    tracking device; background (VI-)BA may run on a different backend
    (system._worker_device host-CPU routing), so pull everything to host
    first. The buffers are tiny (15x15 cov + a few raw sample rows) and this
    runs on the worker thread — the fetch never touches the tracking
    critical path."""
    import jax

    pres = [jax.tree.map(np.asarray, p) for p in pres]
    cap = max(int(p.acc.shape[0]) for p in pres)
    padded = []
    for p in pres:
        n = int(p.acc.shape[0])
        if n < cap:
            p = p._replace(
                acc=np.pad(p.acc, ((0, cap - n), (0, 0))),
                gyr=np.pad(p.gyr, ((0, cap - n), (0, 0))),
                dts=np.pad(p.dts, ((0, cap - n),)),
            )
        padded.append(p)
    return jax.tree.map(lambda *xs: np.stack(xs), *padded)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: len(a)] = a[:n]
    return out

def _build_obs_tables(m, pts, cam_slot, P):
    """Allocate + fill the padded observation tables for a visual BA problem.

    For fisheye-rig maps (m.rig set) the table width DOUBLES: columns
    [D:2D) carry the right-camera observations of the same slots with
    obs_rig=1 — the reference's EdgeSE3ProjectXYZToBody measurements
    (OptimizableTypes.h:96-160). Returns
    (obs_cam, obs_uv, obs_ur, obs_level, obs_valid, obs_rig, rig_R, rig_t)
    with the last three None for single-camera maps."""
    D = m.cfg.obs_cap
    rig = m.rig is not None
    D2 = 2 * D if rig else D
    obs_cam = np.zeros((P, D2), np.int32)
    obs_uv = np.zeros((P, D2, 2), np.float32)
    obs_ur = np.full((P, D2), -1.0, np.float32)
    obs_level = np.zeros((P, D2), np.int32)
    obs_valid = np.zeros((P, D2), bool)
    _fill_obs_table(m, pts, cam_slot, obs_cam[:, :D], obs_uv[:, :D],
                    obs_ur[:, :D], obs_level[:, :D], obs_valid[:, :D])
    if not rig:
        return obs_cam, obs_uv, obs_ur, obs_level, obs_valid, None, None, None
    n = len(pts)
    r_lv = m.mp_obs_r_level[pts]                       # (n, D)
    has_r = (r_lv >= 0) & obs_valid[:n, :D]
    obs_cam[:n, D:] = obs_cam[:n, :D]
    obs_uv[:n, D:] = m.mp_obs_r_uv[pts]
    obs_level[:n, D:] = np.maximum(r_lv, 0)
    obs_valid[:n, D:] = has_r
    obs_rig = np.zeros((P, D2), np.int32)
    obs_rig[:, D:] = 1
    R_rl, t_rl = m.rig
    rig_R = np.stack([np.eye(3, dtype=np.float32),
                      np.asarray(R_rl, np.float32)])
    rig_t = np.stack([np.zeros(3, np.float32),
                      np.asarray(t_rl, np.float32)])
    return obs_cam, obs_uv, obs_ur, obs_level, obs_valid, obs_rig, rig_R, rig_t


def _fill_obs_table(m, pts, cam_slot, obs_cam, obs_uv, obs_ur, obs_level, obs_valid):
    """Vectorized observation-table fill: the SoA obs table indexes straight
    into the problem arrays — no per-(point, slot) Python loop."""
    p = len(pts)
    if p == 0:
        return obs_cam, obs_uv, obs_ur, obs_level, obs_valid
    lookup = np.full(m.cfg.max_kf, -1, np.int32)
    for c, i in cam_slot.items():
        lookup[c] = i
    kf_tab = m.mp_obs_kf[pts]            # (p, D)
    idx_tab = m.mp_obs_idx[pts]
    valid_tab = kf_tab >= 0
    kf_safe = np.maximum(kf_tab, 0)
    idx_safe = np.maximum(idx_tab, 0)
    slots = np.where(valid_tab, lookup[kf_safe], -1)
    use = valid_tab & (slots >= 0)
    obs_cam[:p] = np.where(use, slots, 0)
    obs_uv[:p] = np.where(use[..., None], m.kf_feat_xy[kf_safe, idx_safe], 0.0)
    obs_ur[:p] = np.where(use, m.kf_feat_ur[kf_safe, idx_safe], -1.0)
    obs_level[:p] = np.where(use, m.kf_feat_level[kf_safe, idx_safe], 0)
    obs_valid[:p] = use
    return obs_cam, obs_uv, obs_ur, obs_level, obs_valid
