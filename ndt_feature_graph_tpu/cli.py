"""Command-line interface.

Replaces the reference's boost::program_options drivers:
  simulate  — generate a synthetic sequence        (simulate_scans role)
  slam      — online graph SLAM over a sequence    (ndt_graph_offline)
  optimize  — offline loop closure on a checkpoint (ndt_feature_graph_opt,
              flags mirror graph_opt.cpp:38-56)
  eval      — ATE between two TUM trajectory files
Run:  python -m ndt_feature_graph_tpu.cli <cmd> --help
JAX picks the GPU when there is one; JAX_PLATFORMS=cpu runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _params_from_args(a):
    from ndt_feature_graph_tpu.config import (
        FeatureParams,
        FuserParams,
        GraphParams,
        NDTMapParams,
        SLAMParams,
    )

    return SLAMParams(
        fuser=FuserParams(
            ndt=NDTMapParams(
                resolution=a.resolution,
                size_x=a.map_size,
                size_y=a.map_size,
                sensor_range=a.sensor_range,
                max_points_per_scan=max(a.num_beams, 512),
                max_cells=a.max_cells,
            ),
            features=FeatureParams(
                num_beams=a.num_beams, max_range=a.sensor_range
            ),
        ),
        graph=GraphParams(
            new_node_transl_dist=a.new_node_dist,
            max_nodes=a.max_nodes,
            valid_max_score=a.max_score,
            valid_max_dist=a.max_dist,
            valid_max_angular_dist=a.max_angular_dist,
            valid_min_idx_dist=a.min_idx_dist,
            online_loop_closure=getattr(a, "online_lc", False),
            solver=getattr(a, "solver", "auto"),
        ),
    )


def _add_common(p):
    p.add_argument("--resolution", type=float, default=0.5)
    p.add_argument("--map-size", type=float, default=40.0)
    p.add_argument("--sensor-range", type=float, default=15.0)
    p.add_argument("--num-beams", type=int, default=360)
    p.add_argument("--max-cells", type=int, default=512)
    p.add_argument("--new-node-dist", type=float, default=3.0)
    p.add_argument("--max-nodes", type=int, default=64)
    # getValidLinks gates (graph_opt.cpp:49-52 defaults).
    p.add_argument("--max-score", type=float, default=0.1)
    p.add_argument("--max-dist", type=float, default=1.0)
    p.add_argument("--max-angular-dist", type=float, default=0.2)
    p.add_argument("--min-idx-dist", type=int, default=2)
    p.add_argument(
        "--solver", choices=["auto", "dense", "direct"], default="auto",
        help="pose-graph solver: dense Cholesky, exact segment-Schur "
             "(O(E) memory), or auto by node count",
    )
    p.add_argument(
        "--online-lc", action="store_true",
        help="close loops online at node splits (incremental solve)",
    )


def cmd_simulate(a):
    import jax
    from ndt_feature_graph_tpu.io import dataset

    if a.trajectory == "loop":
        traj = dataset.multi_loop_trajectory(
            n_loops=a.laps, steps_per_loop=a.steps, radius=a.radius
        )
    else:
        traj = dataset.corridor_trajectory(a.steps)
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(a.seed),
        traj,
        num_beams=a.num_beams,
        max_range=a.sensor_range,
        odom_noise=(a.odom_noise, a.odom_noise, a.odom_noise / 2.5),
    )
    if a.out.endswith(".bag"):
        from ndt_feature_graph_tpu.io import rosbag

        rosbag.write_bag(a.out, seq, max_range=a.sensor_range)
    else:
        dataset.save_sequence(a.out, seq)
    print(f"wrote {a.out}: {traj.shape[0]} steps, {a.num_beams} beams")


def _load_any_sequence(path, max_range=30.0):
    from ndt_feature_graph_tpu.io import dataset

    if path.endswith(".clf") or path.endswith(".log"):
        from ndt_feature_graph_tpu.io import carmen

        return carmen.read_carmen_sequence(path, max_range=max_range)
    if path.endswith(".bag"):
        from ndt_feature_graph_tpu.io import rosbag

        seq, _stamps = rosbag.read_bag_sequence(path, max_range=max_range)
        return seq
    return dataset.load_sequence(path)


def _sync_beams(a, seq):
    """The dataset decides the beam count; the flag is only a default
    for synthetic runs."""
    nb = int(seq.ranges.shape[1])
    if nb != a.num_beams:
        print(f"note: dataset has {nb} beams (flag said {a.num_beams})")
        a.num_beams = nb


def cmd_slam(a):
    import numpy as np
    from ndt_feature_graph_tpu import pipeline
    from ndt_feature_graph_tpu.io import dataset, tum

    seq = _load_any_sequence(a.dataset, max_range=a.sensor_range)
    _sync_beams(a, seq)
    params = _params_from_args(a)
    slam, stats = pipeline.run_slam(params, seq, verbose=True)
    ate = pipeline.evaluate(slam, seq)
    stats["ate_rmse_m"] = ate
    print(json.dumps(stats))

    os.makedirs(a.out, exist_ok=True)
    est = np.stack(slam.trajectory)
    t_idx = np.asarray(slam.times, int)
    tum.write_tum(os.path.join(a.out, "est.tum"), slam.times, est)
    tum.write_tum(
        os.path.join(a.out, "gt.tum"),
        slam.times,
        np.asarray(seq.gt)[t_idx],
    )
    slam.save(os.path.join(a.out, "graph.npz"))
    if a.plot:
        from ndt_feature_graph_tpu.viz import plot

        plot.save_slam_overview(
            os.path.join(a.out, "overview.png"),
            slam,
            gt=np.asarray(seq.gt)[t_idx],
        )
    if a.html:
        from ndt_feature_graph_tpu.viz import html as viz_html

        viz_html.export_html(
            os.path.join(a.out, "viewer.html"),
            slam,
            gt=np.asarray(seq.gt)[t_idx],
        )
    if a.optimize:
        slam.optimize_offline(verbose=True)
        tum.write_tum(
            os.path.join(a.out, "nodes_opt.tum"),
            list(range(len(slam.node_T))),
            np.stack(slam.node_T),
        )
    print(f"outputs in {a.out}")


def cmd_fuse(a):
    """Scan-to-submap NDT odometry (the NDTFuserHMT baseline node)
    with an optional HMT live map: --hmt-dir enables the disk-backed
    rolling window (recentres spill evicted tiles to the store and
    recall revisited ground — beHMT + hmt_map_dir,
    ndt_feature_fuser_hmt.h:5-16) and persists it there at the end.
    Resume a previous run from the same directory with --resume."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ndt_feature_graph_tpu.fusion import fuser, scan_driver
    from ndt_feature_graph_tpu.fusion.hmt_driver import HMTFuser
    from ndt_feature_graph_tpu.io import dataset, tum

    seq = _load_any_sequence(a.dataset, max_range=a.sensor_range)
    _sync_beams(a, seq)
    params = _params_from_args(a).fuser
    pts_all, mask_all = jax.vmap(dataset.scan_to_points)(
        seq.ranges, seq.hit
    )
    import time

    t0 = time.perf_counter()
    if a.hmt_dir:
        if a.resume and os.path.exists(
            os.path.join(a.hmt_dir, "hmt.json")
        ):
            hf = HMTFuser.load(a.hmt_dir, params)
        else:
            hf = HMTFuser(
                params, seq.gt[0], jnp.zeros(3), pts_all[0],
                mask_all[0], recenter_margin=a.recenter_margin,
            )
        traj = hf.run_sequence(
            seq.odom[1:], pts_all[1:], mask_all[1:], chunk=a.chunk
        )
        hf.save(a.hmt_dir)
        extra = {
            "n_recenters": hf.n_recenters,
            "stored_cells": hf.stored_cell_count(),
            "recenter_s": [round(t, 3) for t in hf.recenter_times],
        }
    else:
        state = fuser.initialize(
            params, seq.gt[0], jnp.zeros(3), pts_all[0], mask_all[0]
        )
        _f, traj_j, _s = scan_driver.run_sequence(
            params, state, seq.odom[1:], pts_all[1:], mask_all[1:]
        )
        traj = np.asarray(traj_j)
        extra = {}
    wall = time.perf_counter() - t0
    n = traj.shape[0]
    gt = np.asarray(seq.gt[1: n + 1])
    ate = float(
        np.sqrt(np.mean(np.sum((traj[:, :2] - gt[:, :2]) ** 2, -1)))
    )
    os.makedirs(a.out, exist_ok=True)
    tum.write_tum(
        os.path.join(a.out, "est.tum"), list(range(1, n + 1)), traj
    )
    print(json.dumps({
        "n_scans": n, "wall_s": round(wall, 3),
        "scans_per_sec": round(n / max(wall, 1e-9), 2),
        "ate_rmse_m": round(ate, 4), **extra,
    }))
    print(f"outputs in {a.out}")


def cmd_optimize(a):
    import numpy as np
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
    from ndt_feature_graph_tpu.io import tum

    params = _params_from_args(a)
    slam = NDTFeatureGraphSLAM.load(a.graph, params)
    print(f"loaded {len(slam.nodes)} nodes, "
          f"{len(slam.odom_edges)} odometry edges")
    before = np.stack(slam.node_T)
    out = np.asarray(slam.optimize_offline(verbose=True))
    print("max node move:",
          float(np.max(np.linalg.norm(out[:, :2] - before[:, :2], axis=1))))
    tum.write_tum(a.out, list(range(len(out))), out)
    print(f"wrote {a.out}")


def cmd_localize(a):
    """MCL tracking (and optional kidnapped-robot recovery via place
    recognition) against the map built from the first part of a
    sequence — the localization-monitor / MCL-node role."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ndt_feature_graph_tpu.config import FeatureParams, MotionParams
    from ndt_feature_graph_tpu.io import dataset
    from ndt_feature_graph_tpu.localization import mcl, place_rec
    from ndt_feature_graph_tpu.ops import d2d, ndt_map
    from ndt_feature_graph_tpu.core import se2

    seq = _load_any_sequence(a.dataset, max_range=a.sensor_range)
    _sync_beams(a, seq)
    params = _params_from_args(a)
    mp = params.fuser.ndt
    t_total = int(seq.gt.shape[0])
    split = t_total // 2

    # Map from the first half at GT poses (localization assumes a map).
    grid = ndt_map.empty_grid(mp, jnp.zeros(2))
    fp = FeatureParams(num_beams=a.num_beams, max_range=a.sensor_range)
    db = place_rec.empty_database(fp, capacity=32)
    for t in range(0, split, 2):
        pts, mask = dataset.scan_to_points(seq.ranges[t], seq.hit[t])
        world = se2.transform_points(seq.gt[t], pts)
        grid = ndt_map.add_points(grid, mp, world, mask)
        grid = ndt_map.update_occupancy(
            grid, mp, seq.gt[t][:2], world, mask
        )
        db = place_rec.insert_scan(
            db, fp, seq.gt[t], seq.ranges[t], seq.hit[t]
        )
    tgt = d2d.make_dense_target(grid, mp)

    if a.kidnapped:
        from ndt_feature_graph_tpu.localization import monitor

        # The robot "wakes up" somewhere inside the mapped area, at a
        # scan NOT stored in the database (odd index).
        q = split // 3 * 2 + 1
        pose, best, n = place_rec.relocalize(
            db, fp, seq.ranges[q], seq.hit[q], jax.random.PRNGKey(1),
            min_num_matches=a.min_matches,
        )
        badness = float("nan")
        if pose is not None:
            # Gate on scan-pose badness, as the localization monitor
            # does before publishing (localization_monitor_node.cpp:
            # 376-396): a wrong-place RANSAC match scores badly against
            # the distance field.
            dmap = monitor.build_distance_map(
                grid.occ, grid.origin, mp.resolution
            )
            pts_q, mask_q = dataset.scan_to_points(
                seq.ranges[q], seq.hit[q]
            )
            badness = float(
                monitor.badness(dmap, jnp.asarray(pose), pts_q, mask_q)
            )
            if badness > a.max_badness:
                pose = None
        err = (
            float(np.linalg.norm(pose[:2] - np.asarray(seq.gt[q])[:2]))
            if pose is not None else float("nan")
        )
        print(json.dumps({
            "relocalized": pose is not None,
            "inliers": n,
            "badness_m": badness,
            "position_error_m": err,
        }))
        return

    loc = mcl.MCL(mp, MotionParams(), tgt, n_particles=a.particles)
    loc.initialize(seq.gt[split], spread_xy=0.5, spread_theta=0.2)
    errs = []
    for t in range(split + 1, t_total):
        pts, mask = dataset.scan_to_points(seq.ranges[t], seq.hit[t])
        est = loc.step(seq.odom[t], pts, mask)
        errs.append(float(jnp.linalg.norm(est[:2] - seq.gt[t][:2])))
    print(json.dumps({
        "steps": len(errs),
        "mean_error_m": float(np.mean(errs)),
        "final_error_m": errs[-1] if errs else None,
    }))


def cmd_calibrate(a):
    """Laser->base extrinsic grid search over consecutive scan pairs
    (laser2d_extrinsic_calibration role)."""
    import numpy as np
    from ndt_feature_graph_tpu.io import dataset
    from ndt_feature_graph_tpu.utils import pairwise

    seq = _load_any_sequence(a.dataset, max_range=a.sensor_range)
    pairs, rels = [], []
    step = max(1, seq.gt.shape[0] // (a.pairs + 1))
    for k in range(0, min(a.pairs * step, seq.gt.shape[0] - step), step):
        pa, ma = dataset.scan_to_points(seq.ranges[k], seq.hit[k])
        pb, mb = dataset.scan_to_points(
            seq.ranges[k + step], seq.hit[k + step]
        )
        pairs.append(((pa, ma), (pb, mb)))
        import jax.numpy as jnp

        from ndt_feature_graph_tpu.core import se2

        rels.append(np.asarray(se2.sub(seq.gt[k], seq.gt[k + step])))
    best, scores = pairwise.calibrate_extrinsic(
        pairs, rels, search_xy=a.search_xy,
        search_theta=a.search_theta, n=a.grid,
    )
    print(json.dumps({
        "extrinsic": [float(x) for x in np.asarray(best)],
        "candidates": int(np.asarray(scores).shape[0]),
    }))


def cmd_export_map(a):
    """Stitched occupancy export from a graph checkpoint
    (toOccupancyGrid role)."""
    import numpy as np
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
    from ndt_feature_graph_tpu.utils import occupancy

    params = _params_from_args(a)
    slam = NDTFeatureGraphSLAM.load(a.graph, params)
    prob, origin, res = occupancy.stitch_graph_occupancy(slam)
    occupancy.write_pgm(a.out, prob)
    print(json.dumps({
        "cells": list(prob.shape),
        "origin": [float(x) for x in origin],
        "resolution": res,
        "out": a.out,
    }))


def cmd_eval(a):
    from ndt_feature_graph_tpu.io import tum

    _, est = tum.read_tum(a.est)
    _, gt = tum.read_tum(a.gt)
    n = min(len(est), len(gt))
    print(
        json.dumps(
            {
                "ate_rmse_m": tum.ate_rmse(est[:n], gt[:n]),
                "ate_rmse_aligned_m": tum.ate_rmse(
                    est[:n], gt[:n], align=True
                ),
                "poses": n,
            }
        )
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ndt_feature_graph_tpu",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="generate synthetic sequence")
    p.add_argument("--out", required=True)
    p.add_argument("--trajectory", choices=["loop", "corridor"],
                   default="loop")
    p.add_argument("--steps", type=int, default=100,
                   help="scans (per lap for --trajectory loop)")
    p.add_argument("--laps", type=int, default=1,
                   help="revolutions of the loop trajectory")
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--num-beams", type=int, default=360)
    p.add_argument("--sensor-range", type=float, default=15.0)
    p.add_argument("--odom-noise", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("slam", help="run online graph SLAM")
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--optimize", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--html", action="store_true",
                   help="write an interactive viewer (viewer.html)")
    _add_common(p)
    p.set_defaults(fn=cmd_slam)

    p = sub.add_parser(
        "fuse", help="scan-to-submap NDT odometry (NDTFuserHMT node);"
        " --hmt-dir enables the disk-backed HMT live map"
    )
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--hmt-dir", default=None,
                   help="HMT tile-store directory (beHMT + hmt_map_dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from an existing --hmt-dir")
    p.add_argument("--recenter-margin", type=float, default=10.0)
    p.add_argument("--chunk", type=int, default=16)
    _add_common(p)
    p.set_defaults(fn=cmd_fuse)

    p = sub.add_parser("optimize", help="offline loop-closure optimization")
    p.add_argument("--graph", required=True, help="graph.npz checkpoint")
    p.add_argument("--out", required=True, help="optimized nodes TUM file")
    _add_common(p)
    p.set_defaults(fn=cmd_optimize)

    p = sub.add_parser("eval", help="ATE between TUM files")
    p.add_argument("--est", required=True)
    p.add_argument("--gt", required=True)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser(
        "localize", help="MCL tracking / kidnapped-robot recovery"
    )
    p.add_argument("--dataset", required=True)
    p.add_argument("--kidnapped", action="store_true")
    p.add_argument("--particles", type=int, default=512)
    p.add_argument("--min-matches", type=int, default=8)
    p.add_argument("--max-badness", type=float, default=0.5)
    _add_common(p)
    p.set_defaults(fn=cmd_localize)

    p = sub.add_parser(
        "calibrate", help="laser extrinsic grid search"
    )
    p.add_argument("--dataset", required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--search-xy", type=float, default=0.4)
    p.add_argument("--search-theta", type=float, default=0.25)
    p.add_argument("--grid", type=int, default=7)
    _add_common(p)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser(
        "export-map", help="stitched occupancy PGM from a checkpoint"
    )
    p.add_argument("--graph", required=True)
    p.add_argument("--out", required=True)
    _add_common(p)
    p.set_defaults(fn=cmd_export_map)

    a = ap.parse_args(argv)
    from ndt_feature_graph_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    a.fn(a)


if __name__ == "__main__":
    main()
