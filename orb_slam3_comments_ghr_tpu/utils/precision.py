"""Full-f32 matmul guard for geometry-critical programs.

At default precision an accelerator may run float32 matmuls with reduced
input precision: bf16 (8-bit mantissa, ~0.4% relative error) on some, TF32
(10-bit mantissa) on NVIDIA GPUs from Ampere on, the H100 included. That is
an acceptable trade for the big front-end contractions (pyramid resize,
in-patch blur, IC-angle moments), whose effect on keypoints and rBRIEF bits
`chip_smoke.py` measures against the CPU, but poisonous for the small
matmuls that SET map geometry — triangulation, two-view init, Sim3, inertial
init, pose graphs: their output feeds every downstream estimate and
lower-bounds the system ATE at centimeters. These matmuls are tiny
(3x3/4x4/batched-small), so full f32 costs nothing measurable. The XLA:CPU
backend always runs f32; there the decorator changes nothing."""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    """Trace `fn` under jax.default_matmul_precision('highest'). Apply UNDER
    jax.jit (closest to the function) so the context is active at trace
    time."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
