"""Multi-seed stability of the 570-node offline pipeline (stable
across >= 3 seeds).  Same scenario as
tests/test_scaling_e2e.py, parametrized by simulator seed.

Usage: python examples/eval_scaling_seeds.py SEED [SEED...]
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from examples.diag_570_build import PARAMS  # noqa: E402
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu.io import dataset, tum

for seed in [int(a) for a in sys.argv[1:]]:
    traj = dataset.multi_loop_trajectory(
        n_loops=8, steps_per_loop=165, radius=5.0
    )
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(seed), traj, num_beams=128, max_range=6.0,
        odom_noise=(0.008, 0.008, 0.004),
    )
    slam = NDTFeatureGraphSLAM(PARAMS, seed=0)
    slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    slam.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=8)
    slam.finalize_current_node()
    n = len(slam.nodes)
    traj_est = np.stack(slam.trajectory)
    node_T = np.stack(slam.node_T)
    idx = np.array([
        int(np.argmin(np.abs(traj_est - node_T[i]).sum(-1)))
        for i in range(n)
    ])
    gt_nodes = np.asarray(seq.gt)[idx]
    e_on = tum.ate_rmse(node_T, gt_nodes)
    e_on_al = tum.ate_rmse(node_T, gt_nodes, align=True)
    out = np.asarray(slam.optimize_offline())
    e_af = tum.ate_rmse(out[:n], gt_nodes)
    e_af_al = tum.ate_rmse(out[:n], gt_nodes, align=True)
    print(
        f"seed={seed} nodes={n} online={e_on:.3f} (al {e_on_al:.3f}) "
        f"after={e_af:.3f} (al {e_af_al:.3f}) "
        f"improvement={e_on / max(e_af, 1e-9):.1f}x",
        flush=True,
    )
