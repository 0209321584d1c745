"""Windowed descriptor matching (ops.matching: window_mask + int8 Hamming
contraction + masked top-2) against a brute-force numpy reference."""

import numpy as np
import jax.numpy as jnp
import pytest

from orb_slam3_comments_ghr_tpu.ops import matching

BIG = 1 << 20


def _problem(seed, L, N, radius):
    rng = np.random.default_rng(seed)
    return dict(
        qd=rng.integers(0, 2**32, (L, 8), dtype=np.uint32),
        td=rng.integers(0, 2**32, (N, 8), dtype=np.uint32),
        quv=(rng.random((L, 2)) * 600).astype(np.float32),
        txy=(rng.random((N, 2)) * 600).astype(np.float32),
        qrad=np.full((L,), radius, np.float32),
        qlo=rng.integers(0, 3, L).astype(np.int32),
        tlvl=rng.integers(0, 8, N).astype(np.int32),
        tval=rng.random(N) > 0.1,
    )


def _brute_force(p):
    """Per query row: candidates inside the +-radius box, in the level band
    [lo, lo+2] and valid; best = lowest Hamming distance (first index on
    ties), second = lowest over the other candidates; BIG when absent."""
    L = p["qd"].shape[0]
    idx = np.zeros(L, np.int64)
    best = np.full(L, BIG, np.int64)
    second = np.full(L, BIG, np.int64)
    for r0 in range(0, L, 512):
        rows = slice(r0, r0 + 512)
        ham = np.bitwise_count(
            p["qd"][rows, None, :] ^ p["td"][None, :, :]).sum(-1)
        r = p["qrad"][rows, None]
        lo = p["qlo"][rows, None]
        cand = ((np.abs(p["quv"][rows, None, 0] - p["txy"][None, :, 0]) < r)
                & (np.abs(p["quv"][rows, None, 1] - p["txy"][None, :, 1]) < r)
                & (p["tlvl"][None] >= lo) & (p["tlvl"][None] <= lo + 2)
                & p["tval"][None])
        for k, (h, c) in enumerate(zip(ham, cand)):
            js = np.flatnonzero(c)
            if len(js) == 0:
                continue
            order = js[np.argsort(h[js], kind="stable")]
            idx[r0 + k] = order[0]
            best[r0 + k] = h[order[0]]
            if len(order) > 1:
                second[r0 + k] = h[order[1]]
    return idx, best, second


def _match(p):
    L = p["qd"].shape[0]
    lo = jnp.asarray(p["qlo"])
    mask = matching.window_mask(
        jnp.asarray(p["quv"]), jnp.zeros(L, jnp.int32), jnp.asarray(p["txy"]),
        jnp.asarray(p["tlvl"]), jnp.asarray(p["tval"]), jnp.asarray(p["qrad"]),
        level_lo=lo, level_hi=lo + 2,
    )
    dist = matching.hamming_matrix_mxu(jnp.asarray(p["qd"]),
                                       jnp.asarray(p["td"]))
    return [np.asarray(x) for x in matching.masked_best2(dist, mask)]


class TestWindowMatch:
    @pytest.mark.parametrize("seed,radius,L,N", [
        (0, 80.0, 256, 512), (1, 15.0, 256, 512), (2, 300.0, 256, 512),
        (4, 60.0, 4096, 1024),  # the tracker's widths: local points x feats
    ])
    def test_matches_brute_force(self, seed, radius, L, N):
        p = _problem(seed, L, N, radius)
        idx, best, second = _match(p)
        idx_ref, best_ref, second_ref = _brute_force(p)
        np.testing.assert_array_equal(best, best_ref)
        np.testing.assert_array_equal(second, second_ref)
        has = best_ref < BIG
        assert has.any()
        np.testing.assert_array_equal(idx[has], idx_ref[has])

    def test_no_candidates_row(self):
        p = _problem(3, 256, 512, 0.0)  # radius 0: nothing is inside
        _, best, second = _match(p)
        assert (best >= BIG).all() and (second >= BIG).all()
