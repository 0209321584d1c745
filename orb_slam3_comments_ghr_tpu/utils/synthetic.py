"""Synthetic world / sequence generation — the deterministic 'fake backend'
the reference lacks (SURVEY.md §4 implication): rendered feature tracks and
images with known ground-truth trajectory, for integration tests and
benchmarks scoreable by utils.evaluation.ate_rmse."""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..frontend.types import Features
from ..ops import cameras, lie


@dataclasses.dataclass
class World:
    points: np.ndarray       # (W,3)
    desc: np.ndarray         # (W,8) uint32 per-landmark descriptor
    patches: np.ndarray      # (W,21,21) float32 texture patch (for rendering)
    priority: np.ndarray     # (W,) detection priority — a real detector
                             # re-finds the same strong corners every frame


def make_world(seed: int, n_points: int = 4000, extent=(20.0, 12.0, 8.0),
               center=(0.0, 0.0, 10.0)) -> World:
    rng = np.random.default_rng(seed)
    pts = (rng.random((n_points, 3)) - 0.5) * np.asarray(extent) + np.asarray(center)
    desc = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)
    patches = rng.random((n_points, 21, 21)).astype(np.float32) * 200.0 + 30.0
    priority = rng.random(n_points).astype(np.float32)
    return World(points=pts.astype(np.float32), desc=desc, patches=patches,
                 priority=priority)


def make_ring_world(seed: int, n_points: int = 6000, r_min: float = 6.0,
                    r_max: float = 18.0, height: float = 8.0) -> World:
    """Landmarks on an annulus around the origin — for outward-looking loop
    trajectories where every heading sees different structure."""
    rng = np.random.default_rng(seed)
    a = rng.random(n_points) * 2 * np.pi
    r = rng.random(n_points) * (r_max - r_min) + r_min
    pts = np.stack(
        [r * np.sin(a), (rng.random(n_points) - 0.5) * height, r * np.cos(a)], -1
    )
    desc = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)
    patches = rng.random((n_points, 21, 21)).astype(np.float32) * 200.0 + 30.0
    priority = rng.random(n_points).astype(np.float32)
    return World(points=pts.astype(np.float32), desc=desc, patches=patches,
                 priority=priority)


def ba_problem(n_points: int, n_kfs: int, obs_per_point: int = 8,
               seed: int = 0):
    """Perturbed full-map BA problem: `n_kfs` cameras on a 4 m baseline, the
    first two fixed at their true poses, `n_points` landmarks 5-13 m out,
    each observed by `obs_per_point` cameras spread over the baseline with
    0.5 px pixel noise. Free poses are perturbed by ~0.02 rad / 2 cm and
    landmarks by 2 cm, so LM has real work to do."""
    from ..optim import ba

    cam = cameras.euroc_cam0()
    K, P, D = n_kfs, n_points, obs_per_point
    kp, kn, kq, ku = jax.random.split(jax.random.PRNGKey(seed), 4)
    uv = jax.random.uniform(kp, (P, 2)) * jnp.array([700.0, 440.0]) + 20.0
    pts = cameras.unproject(cam, uv) * (jax.random.uniform(kn, (P, 1)) * 8 + 5)
    cam_c = jnp.stack([jnp.linspace(-2, 2, K), jnp.zeros(K), jnp.zeros(K)], -1)
    Rg = jnp.broadcast_to(jnp.eye(3), (K, 3, 3))
    tg = -jnp.einsum("kij,kj->ki", Rg, cam_c)
    obs_cam = (
        (jnp.arange(P)[:, None] * 3 + jnp.arange(D)[None, :] * (K // D + 1)) % K
    ).astype(jnp.int32)
    pc = jnp.einsum("pdij,pj->pdi", Rg[obs_cam], pts) + tg[obs_cam]
    uv_obs = cameras.project(cam, pc) + 0.5 * jax.random.normal(ku, (P, D, 2))
    ok = cameras.in_image(cam, uv_obs, 2.0) & (pc[..., 2] > 0.5)
    fixed = jnp.arange(K) < 2
    dxi = jnp.where(fixed[:, None], 0.0, jax.random.normal(kq, (K, 6)) * 0.02)
    dR, dt = lie.se3_exp(dxi)
    R0, t0 = lie.se3_mul(dR, dt, Rg, tg)
    return ba.BAProblem(
        cam_R=R0, cam_t=t0, cam_fixed=fixed,
        p=pts + 0.02, p_valid=jnp.ones((P,), bool),
        obs_cam=obs_cam, obs_uv=uv_obs, obs_ur=jnp.full((P, D), -1.0),
        obs_level=jnp.zeros((P, D), jnp.int32), obs_valid=ok,
    )


def circular_trajectory(n_frames: int, radius: float = 2.0, z_amp: float = 0.2,
                        look_at=(0.0, 0.0, 10.0), arc: float = 0.8,
                        outward: bool = False):
    """List of (R_cw, t_cw) world->cam poses on a horizontal arc. Inward mode
    keeps a fixed target in view; outward mode looks radially out (panorama) —
    the classic loop-closure setup when combined with make_ring_world."""
    poses = []
    look = np.asarray(look_at)
    for i in range(n_frames):
        a = arc * 2 * np.pi * i / n_frames
        c = np.array([radius * np.sin(a), 0.3 * np.sin(2 * a), z_amp * np.sin(3 * a)])
        if outward:
            fwd = np.array([np.sin(a), 0.0, np.cos(a)])
        else:
            fwd = look - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R_wc = np.stack([right, down, fwd], axis=1)  # cam axes in world
        R_cw = R_wc.T
        t_cw = -R_cw @ c
        poses.append((R_cw.astype(np.float32), t_cw.astype(np.float32)))
    return poses


def render_features(
    world: World,
    cam: cameras.Camera,
    R_cw: np.ndarray,
    t_cw: np.ndarray,
    n_feat: int = 1024,
    noise_px: float = 0.4,
    desc_flip_bits: int = 6,
    seed: int = 0,
    stereo: bool = False,
) -> Features:
    """Project world landmarks into the view and emit a Features pytree with
    per-landmark descriptors (a few bits flipped per observation) — the ideal
    front end, isolating the pipeline from the extractor."""
    rng = np.random.default_rng(seed)
    pc = world.points @ R_cw.T + t_cw
    z = pc[:, 2]
    uv = np.asarray(cameras.project(cam, jnp.asarray(pc)))
    vis = (z > 0.3) & np.asarray(cameras.in_image(cam, jnp.asarray(uv), 10.0))
    ids = np.nonzero(vis)[0]
    # deterministic selection by per-landmark detectability (strongest first),
    # with a small per-frame dropout to model detection flicker
    keep = rng.random(len(ids)) > 0.05
    ids = ids[keep]
    ids = ids[np.argsort(-world.priority[ids])][:n_feat]
    n = len(ids)

    xy = np.zeros((n_feat, 2), np.float32)
    desc = np.zeros((n_feat, 8), np.uint32)
    level = np.zeros((n_feat,), np.int32)
    xy[:n] = uv[ids] + rng.normal(0, noise_px, (n, 2))
    desc[:n] = world.desc[ids]
    # flip a few random bits per observation
    for _ in range(desc_flip_bits):
        word = rng.integers(0, 8, n)
        bit = rng.integers(0, 32, n).astype(np.uint32)
        desc[np.arange(n), word] ^= (np.uint32(1) << bit)
    # octave from distance (closer -> finer); keep 0 for simplicity plus a
    # sprinkle of level-1 to exercise the ladder
    level[:n] = (rng.random(n) < 0.15).astype(np.int32)

    valid = np.zeros((n_feat,), bool)
    valid[:n] = True
    u_right = np.full((n_feat,), -1.0, np.float32)
    depth = np.full((n_feat,), -1.0, np.float32)
    if stereo and cam.bf > 0:
        zs = pc[ids, 2].astype(np.float32)
        depth[:n] = zs + rng.normal(0, 0.01, n)
        u_right[:n] = xy[:n, 0] - cam.bf / np.maximum(depth[:n], 1e-6)
    return Features(
        xy=jnp.asarray(xy),
        level=jnp.asarray(level),
        angle=jnp.zeros((n_feat,), jnp.float32),
        response=jnp.where(jnp.asarray(valid), 1.0, -jnp.inf),
        desc=jnp.asarray(desc),
        valid=jnp.asarray(valid),
        u_right=jnp.asarray(u_right),
        depth=jnp.asarray(depth),
    ), ids


@dataclasses.dataclass
class TexturedScene:
    """Two fronto-parallel textured planes (near square patch over a far
    backdrop) — an exactly-renderable world whose appearance is perfectly
    view-consistent, so the real FAST/ORB front end sees repeatable corners
    across frames (what stamped sprites cannot provide)."""

    tex_far: np.ndarray     # (T,T) texture of the far plane
    tex_near: np.ndarray
    z_far: float
    z_near: float
    near_extent: float      # near plane covers |x|,|y| <= near_extent
    scale: float            # texels per meter


def make_textured_scene(seed: int, tex_size: int = 1024, z_far: float = 14.0,
                        z_near: float = 8.0, near_extent: float = 3.0,
                        span: float = 40.0) -> TexturedScene:
    rng = np.random.default_rng(seed)

    def multiscale(t):
        img = np.zeros((t, t), np.float32)
        amp = 1.0
        for cell in (4, 8, 16, 32):
            g = rng.random((t // cell, t // cell)).astype(np.float32)
            img += amp * np.kron(g, np.ones((cell, cell), np.float32))
            amp *= 0.6
        img -= img.min()
        return img / img.max() * 215.0 + 20.0

    return TexturedScene(
        tex_far=multiscale(tex_size),
        tex_near=multiscale(tex_size),
        z_far=z_far,
        z_near=z_near,
        near_extent=near_extent,
        scale=tex_size / span,
    )


def render_image(
    scene: TexturedScene, cam: cameras.Camera, R_cw: np.ndarray, t_cw: np.ndarray
) -> np.ndarray:
    """Exact perspective render (per-pixel plane intersection + nearest-texel
    sampling), vectorized numpy."""
    h, w = cam.height, cam.width
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    rays_c = np.stack(
        [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1
    )
    R_wc = R_cw.T
    c = -R_wc @ t_cw
    rays_w = rays_c @ R_wc.T   # (h,w,3)

    def sample(tex, z_plane):
        lam = (z_plane - c[2]) / rays_w[..., 2]
        X = c[None, None, :] + lam[..., None] * rays_w
        tx = (X[..., 0] * scene.scale + tex.shape[1] / 2)
        ty = (X[..., 1] * scene.scale + tex.shape[0] / 2)
        ti = np.clip(np.round(ty).astype(np.int64), 0, tex.shape[0] - 1)
        tj = np.clip(np.round(tx).astype(np.int64), 0, tex.shape[1] - 1)
        return tex[ti, tj], X, lam

    img_far, _, lam_far = sample(scene.tex_far, scene.z_far)
    img_near, X_near, lam_near = sample(scene.tex_near, scene.z_near)
    near_hit = (
        (np.abs(X_near[..., 0]) <= scene.near_extent)
        & (np.abs(X_near[..., 1]) <= scene.near_extent)
        & (lam_near > 0)
    )
    img = np.where(near_hit & (lam_far > 0), img_near, img_far)
    img = np.where(lam_far > 0, img, 40.0)
    return img.astype(np.float32)


def vi_sequence(
    n_frames: int,
    cam_hz: float = 20.0,
    imu_hz: float = 200.0,
    radius: float = 2.0,
    look_at=(0.0, 0.0, 10.0),
    arc: float = 0.8,
    gravity_tilt=(0.15, -0.1),
):
    """Camera poses + consistent IMU samples from a smooth analytic arc.

    The visual world is deliberately NOT gravity-aligned: gravity points along
    R_tilt @ (0,0,-g) so the IMU initialization has real work to do. Body
    frame == camera frame (Tbc = I). Returns (poses, imu_rows (M,7),
    timestamps)."""
    from ..ops import lie as _lie
    from ..optim.imu import GRAVITY

    look = np.asarray(look_at, np.float64)
    T_total = n_frames / cam_hz

    def pose_at(t):
        a = arc * 2 * np.pi * t / T_total
        c = np.array([radius * np.sin(a), 0.3 * np.sin(2 * a), 0.2 * np.sin(3 * a)])
        fwd = look - c
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, -1.0, 0.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R_wc = np.stack([right, down, fwd], axis=1)
        return R_wc, c

    R_tilt = np.asarray(
        lie_exp := _lie.so3_exp(
            jnp.asarray([gravity_tilt[0], gravity_tilt[1], 0.0])
        )
    )
    g_world = R_tilt @ np.array([0.0, 0.0, -GRAVITY])

    # camera poses at cam_hz
    poses = []
    for i in range(n_frames):
        R_wc, c = pose_at(i / cam_hz)
        R_cw = R_wc.T
        poses.append((R_cw.astype(np.float32), (-R_cw @ c).astype(np.float32)))

    # IMU at imu_hz via central differences of the analytic pose
    rows = []
    h = 1e-4
    n_imu = int(T_total * imu_hz)
    for j in range(1, n_imu):
        t = j / imu_hz
        R0, c0 = pose_at(t - h)
        R1, c1 = pose_at(t)
        R2, c2 = pose_at(t + h)
        v = (c2 - c0) / (2 * h)
        a_w = (c2 - 2 * c1 + c0) / (h * h)
        dR = R1.T @ R2  # body-frame increment over h
        w_b = np.asarray(_lie.so3_log(jnp.asarray(dR))) / h
        f_b = R1.T @ (a_w - g_world)
        rows.append([t, *f_b, *w_b])
    return poses, np.asarray(rows), [i / cam_hz for i in range(n_frames)]


def gt_trajectory(poses) -> list:
    out = []
    for i, (R, t) in enumerate(poses):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        out.append((i * 0.05, T))
    return out
