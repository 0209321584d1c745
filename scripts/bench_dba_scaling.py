"""Distributed-BA scaling measurement.

Runs the landmark-sharded bundle adjustment on meshes of 1, 2, 4, ... up to
`--devices` devices and reports ms per LM iteration and parallel efficiency.
It uses the devices JAX finds and fails if there are fewer than `--devices`.
`--rehearse-cpu` runs the same meshes on virtual CPU devices instead, which
checks meshes and shardings but measures nothing about a real interconnect.

    python scripts/bench_dba_scaling.py [--devices 4] [--points 65536] [--kfs 128]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--kfs", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on virtual CPU devices (shape rehearsal only)")
    args = ap.parse_args()

    import jax

    if args.rehearse_cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.devices)
    from orb_slam3_comments_ghr_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    import numpy as np
    from jax.sharding import Mesh
    from orb_slam3_comments_ghr_tpu.ops import cameras
    from orb_slam3_comments_ghr_tpu.parallel import dba
    from orb_slam3_comments_ghr_tpu.utils import synthetic

    devices = jax.devices()
    if len(devices) < args.devices:
        sys.exit(f"need {args.devices} devices, found {len(devices)}: {devices}")
    cam = cameras.euroc_cam0()
    prob = synthetic.ba_problem(args.points, args.kfs)

    results = {}
    n = 1
    while n <= args.devices:
        mesh = Mesh(np.array(devices[:n]), ("mp",))
        sharded = dba.shard_problem(prob, mesh)
        out = dba.bundle_adjust_sharded(cam, sharded, mesh, iters=args.iters)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(3):
            out = dba.bundle_adjust_sharded(cam, sharded, mesh, iters=args.iters)
            jax.block_until_ready(out)
        results[n] = (time.perf_counter() - t0) / 3 / args.iters * 1000
        n *= 2

    base = results[1]
    print(json.dumps({
        "ms_per_lm_iter": results,
        "efficiency": {k: base / (v * k) for k, v in results.items()},
        "points": args.points, "keyframes": args.kfs, "obs_per_point": 8,
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }))


if __name__ == "__main__":
    main()
