"""Train an ORB vocabulary from a dataset directory or synthetic renders.

DBoW2's offline create() equivalent (the reference ships a pre-trained
1e5-word ORBvoc.txt instead — stripped from this fork):

    python scripts/train_vocabulary.py --images /data/MH01/mav0/cam0/data \
        --out my_voc.npz --k 10 --L 4 [--max-images 120]

With no dataset on disk, --synthetic N renders N textured scenes from varied
viewpoints and trains on descriptors produced by the ACTUAL frontend
extractor, so the tree covers the statistics of our rBRIEF pattern:

    python scripts/train_vocabulary.py --synthetic 120 --out default_voc.npz
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", default=None, help="directory of images")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="render N synthetic views through the real frontend")
    ap.add_argument("--out", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--max-images", type=int, default=120)
    ap.add_argument("--n-features", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (fast local extraction)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from orb_slam3_comments_ghr_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    import numpy as np
    import jax.numpy as jnp
    from orb_slam3_comments_ghr_tpu.frontend import extract
    from orb_slam3_comments_ghr_tpu.retrieval.vocabulary import Vocabulary

    descs, image_ids = [], []

    def add_image(i, img):
        f = extract(jnp.asarray(img), n_features=args.n_features)
        d = np.asarray(f.desc)[np.asarray(f.valid)]
        descs.append(d)
        image_ids.append(np.full(len(d), i, np.int32))

    if args.synthetic:
        from orb_slam3_comments_ghr_tpu.ops import cameras
        from orb_slam3_comments_ghr_tpu.utils import synthetic

        cam = cameras.euroc_cam0()
        rng = np.random.default_rng(args.seed)
        n_scenes = max(1, args.synthetic // 6)
        i = 0
        for s in range(n_scenes):
            scene = synthetic.make_textured_scene(int(rng.integers(0, 1 << 30)))
            poses = synthetic.circular_trajectory(
                6, radius=float(rng.uniform(1.0, 3.0)), arc=1.0)
            for R, t in poses:
                if i >= args.synthetic:
                    break
                add_image(i, synthetic.render_image(scene, cam, R, t))
                i += 1
        print(f"extracted from {i} synthetic views of {n_scenes} scenes")
    else:
        from orb_slam3_comments_ghr_tpu.io.datasets import load_image

        paths = sorted(
            p for ext in ("png", "jpg", "pgm", "npy")
            for p in glob.glob(os.path.join(args.images, f"*.{ext}"))
        )[: args.max_images]
        if not paths:
            raise SystemExit(f"no images found under {args.images}")
        for i, p in enumerate(paths):
            add_image(i, load_image(p))

    corpus = np.concatenate(descs)
    image_ids = np.concatenate(image_ids)
    print(f"training k={args.k} L={args.L} on {len(corpus)} descriptors")
    voc = Vocabulary.train(corpus, k=args.k, L=args.L, seed=args.seed,
                           image_ids=image_ids)
    voc.save(args.out)
    print(f"saved {voc.n_words}-word vocabulary to {args.out} "
          f"(idf range {voc.idf.min():.2f}..{voc.idf.max():.2f})")


if __name__ == "__main__":
    main()
