"""ndt_feature_graph_tpu — 2D lidar NDT+feature graph-SLAM in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
MalcolmMielle/ndt_feature_graph:
NDT submap fusion, FLIRT-style features, joint fusion registration,
pose-graph SLAM with loop closures, relocalization, and multi-chip
scale-out over a jax.sharding.Mesh.

All state is pytrees with static shapes; all hot paths are jitted.
SE(2) is the native parametrization (the reference is effectively 2D:
ndt_feature_graph.cpp:518-525 `force2D`), with SE(3) lifts at I/O edges.
"""

__version__ = "0.1.0"

from ndt_feature_graph_tpu.config import (
    FuserParams,
    GraphParams,
    MatcherParams,
    MotionParams,
    NDTMapParams,
)
