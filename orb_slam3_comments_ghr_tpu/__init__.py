"""orb_slam3_comments_ghr_tpu — a visual / visual-inertial SLAM engine in JAX.

Built from scratch in JAX/XLA with the capabilities of ORB-SLAM3
(reference: Herong1212/ORB_SLAM3_comments_ghr, surveyed in /root/repo/SURVEY.md).

Layout (device programs over SoA state, not a port of the reference's pthread/pointer-graph design):
  ops/       Lie-group math, camera models, low-level device kernels (XLA)
  frontend/  ORB feature pipeline: pyramid, FAST, orientation, rBRIEF, stereo match
  optim/     Estimation core: pose-only LM, windowed BA w/ Schur, inertial factors
  map/       SoA map state: keyframe/map-point pools, covisibility, Atlas
  retrieval/ Bag-of-words vocabulary, inverted index, place recognition
  pipeline/  Tracking / LocalMapping / LoopClosing device programs + host FSM
  parallel/  Mesh / sharding utilities, distributed bundle adjustment
  io/        Dataset loaders, trajectory export, configs
  utils/     Config trees, profiling, evaluation (ATE)
"""

__version__ = "0.1.0"
