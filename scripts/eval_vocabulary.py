"""Retrieval-precision comparison between vocabularies.

Builds a ~300-keyframe database from frames rendered along the real MH01
ground-truth trajectory (hall world, full rBRIEF descriptors), then queries
held-out in-between frames and scores place recognition: a hit = the
top-scoring database keyframe lies within `--radius` meters of the query's
true position. This is the measurement VERDICT r2 #9 asks for (reference
vocabulary: k=10 L=5 ~1e5 words, TemplatedVocabulary.h).

    python scripts/eval_vocabulary.py --voc-a <10k.npz> --voc-b <100k.npz>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


class _NoCovis:
    def covisible_kfs(self, kf, k=10, **kw):
        return []


def _build_frames(n_kf: int, n_feat: int, seed: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from orb_slam3_comments_ghr_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    from orb_slam3_comments_ghr_tpu.ops import cameras
    from orb_slam3_comments_ghr_tpu.utils import gt_replay, synthetic

    times, R_cw, t_cw, p_wc, q_wc = gt_replay.load_euroc_gt("MH01")
    # spread database + query frames over the whole trajectory
    step = max(1, len(times) // (n_kf * 2))
    idx = list(range(0, len(times), step))[: n_kf * 2]
    cam = cameras.euroc_cam0()
    world = gt_replay.make_hall_world(11, p_wc, n_points=48000)
    frames = []
    for i in idx:
        feats, _ = synthetic.render_features(
            world, cam, R_cw[i], t_cw[i], n_feat=n_feat, seed=seed + i
        )
        frames.append(
            (np.asarray(feats.desc), np.asarray(feats.valid), p_wc[i])
        )
    return frames


def _score(voc_path: str, frames, radius: float):
    from orb_slam3_comments_ghr_tpu.retrieval.database import KeyFrameDatabase
    from orb_slam3_comments_ghr_tpu.retrieval.vocabulary import Vocabulary

    voc = Vocabulary.load(voc_path)
    db = KeyFrameDatabase(voc, max_kf=len(frames))
    db_pos = {}
    # even frames -> database, odd frames -> queries
    for kf, (desc, valid, pos) in enumerate(frames):
        if kf % 2 == 0:
            db.add(kf, desc, valid)
            db_pos[kf] = pos
    hits1 = hits3 = n_q = 0
    t0 = time.perf_counter()
    for kf, (desc, valid, pos) in enumerate(frames):
        if kf % 2 == 0:
            continue
        word, _ = voc.transform(desc, valid)
        qbow = voc.bow_vector(word)
        cands = db.detect_candidates(qbow, set(), _NoCovis(), n_best=3,
                                     final_acc_cut=None)
        n_q += 1
        d = [np.linalg.norm(db_pos[c] - pos) for c in cands]
        if d and d[0] <= radius:
            hits1 += 1
        if d and min(d) <= radius:
            hits3 += 1
    dt = time.perf_counter() - t0
    return {
        "voc": os.path.basename(voc_path),
        "n_words": int(voc.n_words),
        "queries": n_q,
        "precision_at_1": round(hits1 / max(n_q, 1), 3),
        "precision_at_3": round(hits3 / max(n_q, 1), 3),
        "query_ms": round(dt / max(n_q, 1) * 1e3, 2),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--voc-a", required=True)
    ap.add_argument("--voc-b", required=True)
    ap.add_argument("--n-kf", type=int, default=300)
    ap.add_argument("--n-features", type=int, default=1024)
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    frames = _build_frames(args.n_kf, args.n_features, args.seed)
    print(f"built {len(frames)} frames ({len(frames)//2} database, "
          f"{len(frames)//2} query)", file=sys.stderr)
    for p in (args.voc_a, args.voc_b):
        print(json.dumps(_score(p, frames, args.radius)))


if __name__ == "__main__":
    main()
