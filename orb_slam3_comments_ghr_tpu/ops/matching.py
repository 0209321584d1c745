"""Binary descriptor matching kernels.

JAX replacement for the reference's ORBmatcher (src/ORBmatcher.cc):
its nine scalar search loops all reduce to one primitive here — a masked
Hamming-distance matrix + top-2 reduction with ratio test — with the mask
encoding the search constraint (projection window, BoW node equality,
epipolar band, grid cell).

Two distance paths, equal bit for bit:
  * `hamming_matrix` — XOR + population_count, elementwise.
  * `hamming_matrix_mxu` — unpack bits to +-1 int8 and contract as an int8
    matmul with int32 accumulation (d = (256 - a.b)/2), which runs on the
    matrix units; the default for the dense candidate sets here.

Constants TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 mirror ORBmatcher.cc:34-36.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = jnp.int32(1 << 20)


def popcount_rows(x: jnp.ndarray) -> jnp.ndarray:
    """Sum of set bits across the last axis of a uint32 array."""
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def hamming_matrix(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """(N,8) x (M,8) uint32 -> (N,M) int32 Hamming distances."""
    x = da[:, None, :] ^ db[None, :, :]
    return popcount_rows(x)


def unpack_pm1(d: jnp.ndarray) -> jnp.ndarray:
    """(N,8) uint32 -> (N,256) int8 in {-1,+1} (bit b -> 2b-1)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (d[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(d.shape[0], 256).astype(jnp.int8)
    return (2 * bits - 1).astype(jnp.int8)


def hamming_matrix_mxu(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """Hamming distances via an int8 matmul: for +-1 vectors,
    a.b = 256 - 2*hamming."""
    A = unpack_pm1(da)
    B = unpack_pm1(db)
    dot = jax.lax.dot_general(
        A, B, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32,
        # integer contraction: keep the int8 path even when the global
        # matmul precision is 'highest' (which would force a f32 conversion)
        precision=jax.lax.Precision.DEFAULT,
    )
    return (256 - dot) // 2


def masked_best2(dist: jnp.ndarray, mask: jnp.ndarray):
    """Row-wise best and second-best over masked columns.

    dist: (N, M) int32; mask: (N, M) bool. Returns (best_idx (N,),
    best (N,), second (N,)). Invalid rows get best=BIG."""
    d = jnp.where(mask, dist, BIG)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(BIG)
    second = jnp.min(d2, axis=1)
    return best_idx.astype(jnp.int32), best, second


def ratio_test(best: jnp.ndarray, second: jnp.ndarray, th: int, ratio: float):
    """best < th and best < ratio * second (ORBmatcher nn-ratio)."""
    return (best < th) & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))


def rotation_consistency(
    ang_a: jnp.ndarray, ang_b: jnp.ndarray, match_idx: jnp.ndarray, valid: jnp.ndarray
):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (ComputeThreeMaxima, ORBmatcher.cc:2341).

    ang_a: (N,) angles of the query features; ang_b: (M,) of the train
    features; match_idx: (N,) index into b; valid: (N,) mask.
    Returns updated valid mask."""
    rot = ang_a - ang_b[match_idx]
    rot = jnp.mod(rot, 2 * jnp.pi)
    bins = jnp.clip(
        (rot * (HISTO_LENGTH / (2 * jnp.pi))).astype(jnp.int32), 0, HISTO_LENGTH - 1
    )
    hist = jnp.zeros((HISTO_LENGTH,), jnp.int32).at[bins].add(valid.astype(jnp.int32))
    top3_vals, top3_idx = jax.lax.top_k(hist, 3)
    # mirror the reference: drop bins 2/3 if much weaker than bin 1
    keep2 = top3_vals[1] > 0.1 * top3_vals[0]
    keep3 = top3_vals[2] > 0.1 * top3_vals[0]
    in_top = (
        (bins == top3_idx[0])
        | ((bins == top3_idx[1]) & keep2)
        | ((bins == top3_idx[2]) & keep3)
    )
    return valid & in_top


def resolve_duplicates(match_idx: jnp.ndarray, dist: jnp.ndarray, valid: jnp.ndarray, m: int):
    """Enforce one query per train feature (the reference checks existing
    assignments per keypoint; here: scatter-min keyed by train index, winner
    takes the slot)."""
    n = match_idx.shape[0]
    SENTINEL = jnp.int32(2**31 - 1)
    # key = dist * n + row (unique per row) so argmin is deterministic; valid
    # distances are <= 256 so the key never overflows int32. Invalid rows get
    # the sentinel (NOT dist*n, which overflows for large pools).
    key = jnp.where(
        valid, jnp.minimum(dist, 256) * n + jnp.arange(n, dtype=jnp.int32), SENTINEL
    )
    best_key = jnp.full((m,), SENTINEL, jnp.int32).at[match_idx].min(key)
    winner = key == best_key[match_idx]
    return valid & winner


def window_mask(
    query_uv: jnp.ndarray,
    query_level: jnp.ndarray,
    feat_xy: jnp.ndarray,
    feat_level: jnp.ndarray,
    feat_valid: jnp.ndarray,
    radius: jnp.ndarray,
    level_lo: jnp.ndarray | None = None,
    level_hi: jnp.ndarray | None = None,
):
    """(N,M) candidate mask: feature within +-radius window of the query's
    predicted pixel and inside the allowed octave band — the grid query
    GetFeaturesInArea (Frame.cc:1608) without the grid, evaluated densely."""
    du = jnp.abs(query_uv[:, 0:1] - feat_xy[None, :, 0])
    dv = jnp.abs(query_uv[:, 1:2] - feat_xy[None, :, 1])
    r = radius[:, None] if radius.ndim == 1 else radius
    m = (du < r) & (dv < r) & feat_valid[None, :]
    if level_lo is not None:
        m = m & (feat_level[None, :] >= level_lo[:, None])
    if level_hi is not None:
        m = m & (feat_level[None, :] <= level_hi[:, None])
    return m


def search_by_window(
    desc_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    mask: jnp.ndarray,
    th: int = TH_LOW,
    ratio: float = 0.9,
    use_mxu: bool = True,
):
    """Generic constrained matcher: all nine ORBmatcher patterns call this
    with a different mask. Returns (idx (N,), dist (N,), valid (N,))."""
    dist = (hamming_matrix_mxu if use_mxu else hamming_matrix)(desc_q, desc_t)
    idx, best, second = masked_best2(dist, mask)
    ok = ratio_test(best, second, th, ratio)
    return idx, best, ok


def search_for_initialization(
    feats_a, feats_b, window: float = 100.0, ratio: float = 0.9, check_rotation: bool = True
):
    """Monocular-initialization matching (SearchForInitialization,
    ORBmatcher.cc:735): level-0 features of frame A matched to features of
    frame B within a +-window pixel box, TH_LOW + ratio + rotation check +
    duplicate resolution."""
    lev0_a = feats_a.valid & (feats_a.level == 0)
    lev0_b = feats_b.valid & (feats_b.level == 0)
    n = feats_a.xy.shape[0]
    radius = jnp.full((n,), window, jnp.float32)
    mask = window_mask(
        feats_a.xy, feats_a.level, feats_b.xy, feats_b.level, lev0_b, radius
    )
    mask = mask & lev0_a[:, None]
    idx, dist, ok = search_by_window(feats_a.desc, feats_b.desc, mask, TH_LOW, ratio)
    if check_rotation:
        ok = rotation_consistency(feats_a.angle, feats_b.angle, idx, ok)
    ok = resolve_duplicates(idx, dist, ok, feats_b.xy.shape[0])
    return idx, dist, ok
