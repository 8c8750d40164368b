"""Calibrate the link-validation score gate.

The reference gates loop-closure links at occupancy-overlap score
<= 0.1 (graph_opt.cpp:49), computed as NDT-cell occupancy overlap
(ndt_feature_node.h:213-252).  Our score is a sigmoid-occupancy MSE
over the rasterized submap grids (graph/links.py
occupancy_overlap_score) — a different statistic on a different
representation, so the transplanted 0.1 needs its own calibration.

Method: run the online pipeline on randomized segment worlds with low
odometry noise (node estimates ~= truth), then for every node pair
whose submaps overlap, score the relative transform at

  true       the estimated relative transform (correct alignment),
  perturbed  the same transform offset by (dr, da) — misalignments the
             gate must reject,
  shuffled   transforms between unrelated node pairs (gross mismatch).

Prints quantile tables for EVAL.md.  CPU, ~5 min:
    python examples/calibrate_link_gate.py
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.graph import links as links_mod
from ndt_feature_graph_tpu.graph import node as node_mod
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu.io import dataset

RES = 0.5
PARAMS = SLAMParams(
    fuser=FuserParams(
        ndt=NDTMapParams(
            resolution=RES, size_x=24.0, size_y=24.0, sensor_range=10.0,
            max_points_per_scan=256, max_cells=256,
        ),
        features=FeatureParams(num_beams=256, max_range=10.0),
    ),
    graph=GraphParams(new_node_transl_dist=2.0, max_nodes=16),
)

PERTURB = [(0.3, 0.0), (0.6, 0.0), (1.0, 0.0), (0.0, 0.2), (0.6, 0.2)]


def collect(seed):
    world, traj = dataset.random_loop_scenario(
        900 + seed, n_steps=70, half_x=9.0, half_y=6.5
    )
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(seed), traj, num_beams=256, max_range=10.0,
        odom_noise=(0.004, 0.004, 0.002),
    )
    slam = NDTFeatureGraphSLAM(PARAMS, seed=0)
    slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    slam.run_sequence_chunked(seq.odom, seq.ranges, seq.hit, chunk=16)
    slam.finalize_current_node()
    nodes = node_mod.stack_nodes(slam.nodes)
    node_T = np.stack(slam.node_T)
    n = len(slam.nodes)

    rng = np.random.default_rng(seed)
    true_s, pert_s, shuf_s = [], {pd: [] for pd in PERTURB}, []
    for i in range(n):
        for j in range(i + 1, n):
            if np.linalg.norm(node_T[i][:2] - node_T[j][:2]) > 6.0:
                continue
            ref = jax.tree.map(lambda x: x[i], nodes)
            mov = jax.tree.map(lambda x: x[j], nodes)
            Trel = se2.sub(jnp.asarray(node_T[i]), jnp.asarray(node_T[j]))
            s, nb = links_mod.occupancy_overlap_score(ref, mov, Trel, RES)
            if int(nb) < 30:        # too little shared support to judge
                continue
            true_s.append(float(s))
            for (dr, da) in PERTURB:
                ang = rng.uniform(0, 2 * np.pi)
                off = jnp.asarray(
                    [dr * np.cos(ang), dr * np.sin(ang),
                     da * rng.choice([-1.0, 1.0])], jnp.float32)
                sp, nbp = links_mod.occupancy_overlap_score(
                    ref, mov, se2.compose(off, Trel), RES
                )
                if int(nbp) >= 30:
                    pert_s[(dr, da)].append(float(sp))
            # gross mismatch: relative transform of a random other pair
            a, b = rng.integers(0, n, 2)
            Tw = se2.sub(jnp.asarray(node_T[a]), jnp.asarray(node_T[b]))
            sw, nbw = links_mod.occupancy_overlap_score(ref, mov, Tw, RES)
            if int(nbw) >= 30:
                shuf_s.append(float(sw))
    return true_s, pert_s, shuf_s


def q(v):
    if not v:
        return "—"
    v = np.asarray(v)
    return (f"{np.quantile(v, .05):.3f} / {np.median(v):.3f} / "
            f"{np.quantile(v, .95):.3f}")


def main():
    true_s, shuf_s = [], []
    pert_s = {pd: [] for pd in PERTURB}
    for seed in range(6):
        t, p, s = collect(seed)
        true_s += t
        shuf_s += s
        for k in PERTURB:
            pert_s[k] += p[k]
    print("| alignment | n | score q05 / median / q95 |")
    print("|---|---|---|")
    print(f"| true | {len(true_s)} | {q(true_s)} |")
    for (dr, da) in PERTURB:
        v = pert_s[(dr, da)]
        print(f"| off by {dr} m / {da} rad | {len(v)} | {q(v)} |")
    print(f"| unrelated pair | {len(shuf_s)} | {q(shuf_s)} |")


if __name__ == "__main__":
    main()
