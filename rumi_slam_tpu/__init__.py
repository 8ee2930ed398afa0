"""rumi_slam_tpu — a visual SLAM engine written as JAX array programs.

A JAX/XLA implementation of the RUMI-SLAM capability set
("Rumination meets VSLAM", T-IE 2023): monocular ORB tracking, local mapping
with windowed bundle adjustment, multi-submap (Atlas) handling on tracking
loss, and the rumination track — a non-realtime back-submap builder whose
result is merged into the realtime maps via timestamp data association, Sim3
alignment, and welding bundle adjustment.

Design stance (vs the reference C++ at /root/reference):
  * pointer-graph map  ->  structure-of-arrays tensors with static capacity
    and validity masks (``mapstate.MapState``);
  * per-frame C++ hot loops  ->  one jitted array program per tracking step;
  * g2o Levenberg-Marquardt  ->  a batched LM engine with Schur-complement
    camera/point elimination in JAX (``optim``);
  * DBoW2 retrieval  ->  brute-force batched int8 Hamming scoring;
  * ROS TCP edge/cloud split  ->  a host-staged frame queue feeding a
    rumination shard on separate devices (``rumination``, ``parallel``).
"""

import jax as _jax

# Geometry Jacobians, Hessian assembly, Schur reduction, and Horn/Umeyama
# correlation matrices are all small float matmuls whose accuracy directly
# bounds optimizer convergence; the GPU default runs float32 matmuls in TF32
# (about three decimal digits).  Force true float32 matmuls.
# The Hamming matchers are int8 dot_generals with an int32 accumulator and
# are unaffected by this setting.
import os as _os

_prec = _os.environ.get("RUMI_MATMUL_PRECISION", "float32")
if _prec != "default":
    _jax.config.update("jax_default_matmul_precision", _prec)

__version__ = "0.1.0"
