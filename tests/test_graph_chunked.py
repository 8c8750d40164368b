"""Device-resident chunked graph driver equivalence: the chunked path
(fusion/scan_driver.run_graph_chunk via slam.run_sequence_chunked) must
reproduce the per-scan host loop exactly — same op order, same PRNG
stream, same splits."""

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu.io import dataset


def _params():
    return SLAMParams(
        fuser=FuserParams(
            ndt=NDTMapParams(
                resolution=0.5, size_x=40.0, size_y=40.0,
                sensor_range=15.0, max_points_per_scan=360,
                max_cells=512,
            ),
            features=FeatureParams(num_beams=360, max_range=15.0),
        ),
        graph=GraphParams(new_node_transl_dist=3.0, max_nodes=16),
    )


def _sequence(t_steps=28):
    traj = dataset.loop_trajectory(t_steps, radius=5.0)
    return dataset.simulate_sequence(
        jax.random.PRNGKey(11), traj, num_beams=360, max_range=15.0
    )


def test_chunked_matches_per_scan():
    params = _params()
    seq = _sequence()
    t_steps = seq.gt.shape[0]

    ref = NDTFeatureGraphSLAM(params, seed=0)
    ref.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    for t in range(1, t_steps):
        ref.update(seq.odom[t], seq.ranges[t], seq.hit[t])

    chk = NDTFeatureGraphSLAM(params, seed=0)
    chk.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    chk.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=8)

    assert len(chk.nodes) == len(ref.nodes)
    assert len(chk.trajectory) == len(ref.trajectory)
    np.testing.assert_allclose(
        np.stack(chk.trajectory), np.stack(ref.trajectory),
        atol=1e-3,
    )
    np.testing.assert_allclose(
        np.stack(chk.node_T), np.stack(ref.node_T), atol=1e-3
    )
    assert len(chk.odom_edges) == len(ref.odom_edges)
    for (ec, er) in zip(chk.odom_edges, ref.odom_edges):
        assert ec[0] == er[0] and ec[1] == er[1]
        np.testing.assert_allclose(ec[2], er[2], atol=1e-3)


def test_chunked_partial_last_chunk():
    """Sequence length not divisible by chunk: padding scans must not
    corrupt state."""
    params = _params()
    seq = _sequence(t_steps=23)

    chk = NDTFeatureGraphSLAM(params, seed=0)
    chk.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    chk.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=16)
    assert len(chk.trajectory) == 23
    traj = np.stack(chk.trajectory)
    err = np.linalg.norm(traj[:, :2] - np.asarray(seq.gt)[:, :2], axis=1)
    assert err.max() < 1.0, err.max()


def test_device_sequence_matches_chunked():
    """The FULLY device-resident driver (run_graph_sequence: splits on
    device into the node bank) must reproduce the chunked path exactly
    — trajectory, node poses, edges, and frozen node payloads."""
    params = _params()
    seq = _sequence()

    chk = NDTFeatureGraphSLAM(params, seed=0)
    chk.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    chk.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=8)

    dev = NDTFeatureGraphSLAM(params, seed=0)
    dev.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    dev.run_sequence_device(seq.odom, seq.ranges, seq.hit)

    assert len(dev.nodes) == len(chk.nodes)
    assert len(dev.trajectory) == len(chk.trajectory)
    np.testing.assert_allclose(
        np.stack(dev.trajectory), np.stack(chk.trajectory), atol=1e-3
    )
    np.testing.assert_allclose(
        np.stack(dev.node_T), np.stack(chk.node_T), atol=1e-3
    )
    assert len(dev.odom_edges) == len(chk.odom_edges)
    for (ed, ec) in zip(dev.odom_edges, chk.odom_edges):
        assert ed[0] == ec[0] and ed[1] == ec[1]
        np.testing.assert_allclose(ed[2], ec[2], atol=1e-3)
        np.testing.assert_allclose(ed[3], ec[3], atol=1e-3)
    # Frozen node payloads (NDT fields, occupancy, feature maps).
    for nd, nc in zip(dev.nodes, chk.nodes):
        for a, b in zip(jax.tree.leaves(nd), jax.tree.leaves(nc)):
            np.testing.assert_allclose(
                np.asarray(a, np.float32), np.asarray(b, np.float32),
                atol=1e-3,
            )
