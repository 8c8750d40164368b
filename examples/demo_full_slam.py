"""End-to-end showcase: full graph SLAM with loop closure on a long
simulated run, producing trajectory/ATE numbers, a stitched occupancy
map, and an overview figure.

Run (CPU works fine; the GPU if present):
    python examples/demo_full_slam.py [outdir]
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu.io import dataset, tum
from ndt_feature_graph_tpu.utils import occupancy
from ndt_feature_graph_tpu.viz import plot


def main(outdir="/tmp/ndtg_demo"):
    os.makedirs(outdir, exist_ok=True)
    params = SLAMParams(
        fuser=FuserParams(
            ndt=NDTMapParams(
                resolution=0.5, size_x=40.0, size_y=40.0,
                sensor_range=15.0, max_points_per_scan=512,
                max_cells=512,
            ),
            features=FeatureParams(num_beams=360, max_range=15.0),
            force_odom_as_est=False,
        ),
        graph=GraphParams(
            new_node_transl_dist=3.0, max_nodes=32,
            valid_max_dist=2.0, valid_max_angular_dist=0.5,
        ),
    )

    traj = dataset.loop_trajectory(160, radius=5.0)
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(11), traj, num_beams=360, max_range=15.0,
        odom_noise=(0.02, 0.02, 0.01),
    )

    slam = NDTFeatureGraphSLAM(params, seed=0)
    slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    for t in range(1, traj.shape[0]):
        slam.update(seq.odom[t], seq.ranges[t], seq.hit[t], t=float(t))
    slam.finalize_current_node()

    est = np.stack(slam.trajectory)
    gt = np.asarray(seq.gt)
    print(f"nodes: {len(slam.nodes)}  online ATE: "
          f"{tum.ate_rmse(est, gt):.3f} m")

    slam.optimize_offline(verbose=True)
    print("offline optimization done")

    tum.write_tum(os.path.join(outdir, "est.tum"), slam.times, est)
    tum.write_tum(os.path.join(outdir, "gt.tum"),
                  slam.times, gt[np.asarray(slam.times, int)])
    plot.save_slam_overview(
        os.path.join(outdir, "overview.png"), slam, gt=gt
    )
    prob, origin, res = occupancy.stitch_graph_occupancy(slam)
    occupancy.write_pgm(os.path.join(outdir, "map.pgm"), prob)
    print(f"artifacts in {outdir}: overview.png, map.pgm, est/gt.tum")


if __name__ == "__main__":
    main(*sys.argv[1:2])
