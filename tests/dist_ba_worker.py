"""Worker process for the 2-process jax.distributed BA test (NOT a test
itself — spawned by tests/test_multiprocess.py). Each process owns 4 virtual
CPU devices; the two processes form one 8-device global mesh via
jax.distributed, shard the SAME deterministic BA problem along the landmark
axis, and run parallel.dba.bundle_adjust_sharded — the reduced camera system
is psum'd ACROSS PROCESS BOUNDARIES (SURVEY.md §5.8 P7). Process 0 writes the
result for the parent test to compare against the single-process solve."""

import argparse
import os
import sys

# the worker always runs on virtual CPU devices, whatever the parent's
# platform: pin it through jax.config before any backend use
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_enable_x64", False)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from orb_slam3_comments_ghr_tpu.parallel import distributed, dba
    from orb_slam3_comments_ghr_tpu.optim import ba
    from orb_slam3_comments_ghr_tpu.ops import cameras

    ok = distributed.initialize(args.coordinator, args.nprocs, args.pid)
    assert ok, "distributed.initialize did not run"
    assert jax.process_count() == args.nprocs, jax.process_count()
    assert len(jax.devices()) == 4 * args.nprocs, len(jax.devices())

    from test_parallel import make_problem, CAM

    prob, Rg, tg, pts = make_problem(jax.random.PRNGKey(0))
    mesh = distributed.global_mesh()

    def put(x, spec):
        sh = NamedSharding(mesh, spec)
        x = np.asarray(x)
        try:
            return jax.device_put(x, sh)
        except Exception:
            return jax.make_array_from_callback(x.shape, sh, lambda i: x[i])

    pt, rep = P("mp"), P()
    sharded = ba.BAProblem(
        cam_R=put(prob.cam_R, rep), cam_t=put(prob.cam_t, rep),
        cam_fixed=put(prob.cam_fixed, rep),
        p=put(prob.p, pt), p_valid=put(prob.p_valid, pt),
        obs_cam=put(prob.obs_cam, pt), obs_uv=put(prob.obs_uv, pt),
        obs_ur=put(prob.obs_ur, pt), obs_level=put(prob.obs_level, pt),
        obs_valid=put(prob.obs_valid, pt),
    )
    R, t, p, inl, cost, _ = dba.bundle_adjust_sharded(
        CAM, sharded, mesh, iters=12
    )
    R = np.asarray(jax.device_get(R))
    t = np.asarray(jax.device_get(t))
    cost = float(jax.device_get(cost))
    if jax.process_index() == 0:
        np.savez(args.out, R=R, t=t, cost=cost)
    print(f"[worker {args.pid}] done cost={cost:.3f}", flush=True)


if __name__ == "__main__":
    main()
