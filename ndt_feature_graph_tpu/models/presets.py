"""Model presets: the framework's named operating points.

Each preset maps to a benchmark config of BASELINE.md / the reference's
shipped configurations:

  p2d_registration    configs[0] — single scan-pair P2D registration
  ndt_odometry        configs[1] — sequential D2D odometry (the
                      reference offline driver's NDT-only mode,
                      ndt_graph_offline.cpp:300-331)
  feature_graph_slam  configs[2-3] — full graph SLAM with FLIRT loop
                      closures (the canonical gustav_laser_tf.launch
                      parameter set: res 0.5, 100x100 m, 30 m range)
  offline_mapper      graph_opt defaults (validation gates
                      graph_opt.cpp:49-52)
  mcl_localizer       NDT-MCL particle localization
  canonical_slam      alias of feature_graph_slam at the canonical
                      operating point
"""

from __future__ import annotations

from ndt_feature_graph_tpu.config import (
    FeatureParams,
    FuserParams,
    GraphParams,
    MatcherParams,
    MotionParams,
    NDTMapParams,
    SLAMParams,
)


def _canonical_ndt(num_beams=720):
    return NDTMapParams(
        resolution=0.5,
        size_x=100.0,
        size_y=100.0,
        sensor_range=30.0,
        max_points_per_scan=max(num_beams, 512),
        max_cells=1024,
    )


def p2d_registration(num_beams=720) -> tuple:
    """(map params, matcher params) for single-pair P2D registration."""
    return _canonical_ndt(num_beams), MatcherParams()


def ndt_odometry(num_beams=720) -> FuserParams:
    """NDT + odometry scan-to-submap odometry (useFeat=false)."""
    return FuserParams(
        ndt=_canonical_ndt(num_beams),
        matcher=MatcherParams(use_feat=False),
        features=FeatureParams(num_beams=num_beams, max_range=30.0),
        motion=MotionParams(),
    )


def feature_graph_slam(
    num_beams=720, new_node_dist=10.0, max_nodes=64
) -> SLAMParams:
    """Full online graph SLAM (the publish_graph_message online node's
    parameter shape: node split 10 m default,
    publish_graph_message.cpp:345)."""
    return SLAMParams(
        fuser=FuserParams(
            ndt=_canonical_ndt(num_beams),
            matcher=MatcherParams(),
            features=FeatureParams(num_beams=num_beams, max_range=30.0),
            motion=MotionParams(),
        ),
        graph=GraphParams(
            new_node_transl_dist=new_node_dist, max_nodes=max_nodes
        ),
    )


def offline_mapper(num_beams=720) -> SLAMParams:
    """Offline mapping defaults (node split 2 m, offline gates —
    ndt_graph_offline.cpp:301 + graph_opt.cpp:49-52)."""
    p = feature_graph_slam(num_beams, new_node_dist=2.0)
    return p.replace(
        graph=p.graph.replace(
            valid_max_score=0.1,
            valid_max_dist=1.0,
            valid_max_angular_dist=0.2,
            valid_min_idx_dist=2,
        )
    )


def fleet_serving(num_beams=720, features=True) -> FuserParams:
    """Multi-robot fleet serving operating point: the batched drivers
    (scan_driver.run_sequence_batch / run_sequence_features_batch)
    with the sensor-window-bounded WIN-BLOCK bf16 gather bank — one
    gathered row per source cell.  bf16 table quantization moves poses
    by a few mm at the canonical op point (chip_smoke.py's fleet
    phase; tests/test_scan_driver.py).  Serve large fleets through
    parallel/scaling.serve_fleet_interleaved for the per-robot
    latency contract."""
    base = FuserParams(
        ndt=_canonical_ndt(num_beams),
        matcher=MatcherParams(use_feat=features),
        features=FeatureParams(num_beams=num_beams, max_range=30.0),
        motion=MotionParams(),
        match_cell_budget=256,
        gather_window_cells=136,
        gather_table_bf16=True,
        gather_block=True,
    )
    return base


def mcl_localizer(num_beams=720):
    """(map params, motion params) for NDT-MCL localization."""
    return _canonical_ndt(num_beams), MotionParams()


def canonical_slam() -> SLAMParams:
    return feature_graph_slam()
