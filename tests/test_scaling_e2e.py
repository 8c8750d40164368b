"""End-to-end large-graph run: the online orchestrator builds 500+
nodes (multi-pass loop), and optimize_offline auto-dispatches to the
exact sparse-direct solver (graph/sparse_direct.py) with distance-gated
candidates and chunked link proposal — the unbounded-trajectory scaling
path (SURVEY.md §5), exercised through the orchestrator rather than the
solver unit test.

The reference's offline CLI would loop O(N^2) pairs sequentially and
hand iSAM a dense problem (ndt_feature_graph_opt.cpp:91-210); here the
candidate set is gated by current estimates + index separation, links
are proposed in fixed-size compiled chunks, and the solve is the
segment-Schur direct method.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ndt_feature_graph_tpu.config import (
    FeatureParams,
    FuserParams,
    GraphParams,
    MatcherParams,
    NDTMapParams,
    SLAMParams,
)
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu.io import dataset, tum

PARAMS = SLAMParams(
    fuser=FuserParams(
        ndt=NDTMapParams(
            resolution=0.5,
            size_x=16.0,
            size_y=16.0,
            sensor_range=6.0,
            max_points_per_scan=128,
            max_cells=128,
            ray_samples=16,
        ),
        matcher=MatcherParams(itr_max=10),
        features=FeatureParams(
            num_beams=128,
            max_range=6.0,
            max_features=8,
            smooth_half_beams=12,
            ransac_hypotheses=64,
            max_correspondences=16,
        ),
    ),
    graph=GraphParams(
        new_node_transl_dist=0.30,
        max_nodes=620,
        max_links=4096,
        # Candidates: revisits only (index separation skips the
        # odometry-chained neighbourhood), gated by current estimates.
        valid_min_idx_dist=25,
        offline_candidate_dist=1.5,
        link_batch_size=256,
        valid_max_dist=1.0,
        valid_max_angular_dist=0.4,
        valid_max_score=0.2,
        # Force the segment-Schur direct solver through the auto
        # dispatch (n > solver_dense_max_nodes).
        solver="auto",
        solver_dense_max_nodes=256,
        solver_max_seg_len=64,
        gn_iterations=12,
        fixpoint_max_rounds=3,
    ),
)


def test_large_graph_direct_solver_end_to_end():
    traj = dataset.multi_loop_trajectory(
        n_loops=8, steps_per_loop=165, radius=5.0
    )
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(7),
        traj,
        num_beams=128,
        max_range=6.0,
        odom_noise=(0.008, 0.008, 0.004),
    )
    slam = NDTFeatureGraphSLAM(PARAMS, seed=0)
    slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    slam.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=8)
    slam.finalize_current_node()
    n = len(slam.nodes)
    assert n >= 500, n

    # Recover each node's start scan: its origin pose equals that
    # scan's trajectory entry exactly (same compose, see
    # run_sequence_chunked).
    traj_est = np.stack(slam.trajectory)
    node_T_before = np.stack(slam.node_T)
    idx = np.array([
        int(np.argmin(np.abs(traj_est - node_T_before[i]).sum(-1)))
        for i in range(n)
    ])
    gt_nodes = np.asarray(seq.gt)[idx]
    err_online = tum.ate_rmse(node_T_before, gt_nodes)

    # Offline: gated candidates -> chunked propose/refine/rescore ->
    # fixpoint validate+solve on the direct path.
    ref, mov, mask = slam.candidate_pairs()
    n_cand = int(np.asarray(mask).sum())
    assert n_cand > 0
    # Gating must cut the candidate set far below all-pairs.
    assert n_cand < n * (n - 1) // 8, n_cand

    out = np.asarray(slam.optimize_offline(verbose=True))
    assert np.isfinite(out).all()
    err_after = tum.ate_rmse(out[:n], gt_nodes)
    err_after_al = tum.ate_rmse(out[:n], gt_nodes, align=True)
    err_online_al = tum.ate_rmse(node_T_before, gt_nodes, align=True)
    print(
        f"nodes={n} candidates={n_cand} "
        f"node-ATE online={err_online:.3f} (aligned {err_online_al:.3f}) "
        f"after={err_after:.3f} (aligned {err_after_al:.3f})"
    )
    # Post-optimization bounds, with margin (round-2 verdict: green
    # with >= 2x, i.e. after-opt <= 0.5x online).  Measured at HEAD:
    # after ~0.02 m vs online ~0.60 m (30x) on a ~185 m, 550+-node
    # multi-loop trajectory — the PSD-safe link information
    # (graph/optimize.spd_info_np) + graduated DCS schedule
    # (config.GraphParams robust_*) are what carry it; see EVAL.md §3.
    assert err_after < 0.25, (err_online, err_after)
    assert err_after < err_online * 0.5, (err_online, err_after)
    # The gauge-free (Horn-aligned, standard TUM ATE) error must also
    # improve materially — the unaligned number alone is dominated by
    # the near-free global rotation about the node-0 prior.
    assert err_after_al < err_online_al * 0.5, (
        err_online_al, err_after_al
    )
