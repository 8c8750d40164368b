"""Endurance bench: long sequences with ground revisits at the
canonical operating point (res 0.5 m, 100x100 m map, 30 m range, 720
beams) — the closest shape to the reference's real operating mode
(hours-long bag replays, gustav_laser_tf.launch).

Three rows:

  A. graph endurance — 2000 gated scans, TWO laps of a closed loop
     (every piece of ground revisited), node splits every 2 m,
     device-resident driver; sustained scans/s + raw ATE.
  B. graph + ONLINE LOOP CLOSURE on the same two-lap course through
     the chunked driver (host candidate loop + incremental solve at
     splits); sustained scans/s + node ATE with closures.
  C. HMT endurance — 2000 scans out-and-back over ~4 window widths
     (400 m) through the HMT-backed fuser (fusion/hmt_driver): the
     rolling window spills evicted ground to the tile store on the
     way out and RECALLS it on the way back; sustained scans/s
     including recentre events + the measured per-recentre cost
     + ATE.

Composition note: HMT (beHMT) is a FUSER-mode capability in the
reference too (ndt_feature_fuser_hmt.h:5-16) — the graph mode bounds
each node's submap by construction (fresh fuser per 2-m split), so
its windows never roll; rows A/B carry the revisit+closure story and
row C the spill/recall story.  Reduced-scale asserts:
tests/test_online_loop_closure.py (closures), tests/test_hmt_driver.py
(recall through the driver).

Protocol: device-resident drivers, host-distinct inputs per rep, and
the trajectory readback ends each timed rep.  Median over reps.

Run on the GPU:  timeout 4000 python examples/bench_long_sequence.py
"""

import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
from ndt_feature_graph_tpu.fusion.hmt_driver import HMTFuser
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu.io import dataset
from ndt_feature_graph_tpu.utils.compile_cache import enable_compile_cache

import bench  # repo-root bench: canonical params + honesty gate

T_STEPS = 2000
SPLIT_M = 2.0
REPS = 3


def ate_raw(est, gt):
    n = min(est.shape[0], gt.shape[0])
    return float(np.sqrt(np.mean(
        np.sum((est[:n, :2] - gt[:n, :2]) ** 2, axis=-1)
    )))


def bench_graph(params, seq, online_lc: bool):
    gp = GraphParams(new_node_transl_dist=SPLIT_M, max_nodes=96)
    if online_lc:
        gp = gp.replace(
            online_loop_closure=True, valid_min_idx_dist=1,
            online_lc_candidate_dist=20.0,
        )
    sparams = SLAMParams(fuser=params, graph=gp)

    def run_once(odom):
        slam = NDTFeatureGraphSLAM(sparams, seed=0)
        slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0],
                        seq.hit[0])
        t0 = time.perf_counter()
        if online_lc:
            out = slam.run_sequence_chunked(
                odom, seq.ranges, seq.hit, chunk=64
            )
        else:
            out = slam.run_sequence_device(odom, seq.ranges, seq.hit)
        assert np.isfinite(out).all()
        dt = time.perf_counter() - t0
        return dt, slam, out

    run_once(seq.odom)  # warmup/compile
    times, slam, out = [], None, None
    for k in range(REPS):
        dt, slam, out = run_once(seq.odom + (k + 1) * 1e-5)
        times.append(dt)
    times.sort()
    med = times[len(times) // 2]
    return {
        "scans_per_sec": round((T_STEPS - 1) / med, 2),
        "nodes": len(slam.nodes),
        "ate_raw_m": round(ate_raw(out, np.asarray(seq.gt)), 3),
        "closures": len(getattr(slam, "loop_links", [])),
    }


def bench_hmt(params):
    """Out-and-back over ~4 window widths through the HMT fuser."""
    step = 0.2  # the reference offline driver's motion gate
    x_end = T_STEPS // 2 * step / 2.0 * 2  # 200 m out
    n = T_STEPS // 2
    xs = np.linspace(-x_end / 2, x_end * 1.5 - x_end / 2, n)
    out_leg = np.stack([xs, np.zeros(n), np.zeros(n)], -1)
    back = out_leg[-2::-1].copy()
    traj = jnp.asarray(
        np.concatenate([out_leg, back])[:T_STEPS].astype(np.float32)
    )
    keep = np.stack(
        [np.asarray(traj[:, 0]), np.asarray(traj[:, 1])], -1
    )
    world = dataset.random_world(
        11, half_x=float(np.abs(keep[:, 0]).max()) + 10.0,
        half_y=12.0, n_obstacles=120, keepout=keep, clearance=2.0,
    )
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(11), traj, num_beams=720, max_range=30.0,
        segments=world, odom_noise=(0.004, 0.004, 0.002),
    )
    pts_all, mask_all = jax.vmap(dataset.scan_to_points)(
        seq.ranges, seq.hit
    )
    hf = HMTFuser(
        params, seq.gt[0], jnp.zeros(3), pts_all[0], mask_all[0],
        recenter_margin=15.0,
    )
    t0 = time.perf_counter()
    est = hf.run_sequence(
        seq.odom[1:], pts_all[1:], mask_all[1:], chunk=32
    )
    dt = time.perf_counter() - t0
    rc = sorted(hf.recenter_times)
    return {
        "scans_per_sec": round((T_STEPS - 1) / dt, 2),
        "ate_raw_m": round(ate_raw(est, np.asarray(seq.gt[1:])), 3),
        "n_recenters": hf.n_recenters,
        "recenter_median_s": round(rc[len(rc) // 2], 3) if rc else 0.0,
        "recenter_max_s": round(rc[-1], 3) if rc else 0.0,
        "stored_cells": hf.stored_cell_count(),
        "course_m": round(2 * x_end, 1),
    }


def main():
    enable_compile_cache()
    params = bench.canonical_params()
    # Two laps of the loop: every piece of ground revisited on lap 2.
    traj = dataset.multi_loop_trajectory(
        n_loops=2, steps_per_loop=T_STEPS // 2, radius=4.2
    )
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(0), traj, num_beams=720, max_range=30.0,
        odom_noise=(0.006, 0.006, 0.003),
    )
    max_cells, params = bench.verify_cell_budget(params, seq)

    out = {
        "t_steps": T_STEPS,
        "match_cell_budget": params.match_cell_budget,
        "max_scan_cells_seen": max_cells,
    }
    for name, fn in (
        ("graph", lambda: bench_graph(params, seq, online_lc=False)),
        ("graph_online_lc",
         lambda: bench_graph(params, seq, online_lc=True)),
        ("hmt", lambda: bench_hmt(params)),
    ):
        out[name] = fn()
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
