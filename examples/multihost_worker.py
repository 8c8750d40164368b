"""Multi-process (multi-host-shaped) worker for the distributed
correctness test (tests/test_multihost.py).

Each process is one "host": jax.distributed bootstrap, 4 virtual CPU
devices (the launcher sets XLA_FLAGS), a 2-D (dcn, ici) global mesh
(parallel/mesh.make_mesh_2d), and the edge-sharded solvers running over
BOTH axes — collectives reduce over ICI within the host row and DCN
across rows, the layout SURVEY.md §2.3/§7.9 mandates.  Rank 0 writes
the optimized poses so the test can compare against the single-process
solvers bit-for-bit (same float ops, different reduction placement —
tolerance is float-level).

Usage (launched twice by the test):
  XLA_FLAGS=--xla_force_host_platform_device_count=4 \
  python examples/multihost_worker.py --rank R --nprocs 2 \
      --port P --out out.npz
"""

import argparse

import jax

jax.config.update("jax_platforms", "cpu")  # before any backend init


def build_graph(seed: int = 3, n_nodes: int = 24, n_loop: int = 10):
    """Deterministic noisy loopy pose graph (identical on every rank)."""
    import jax.numpy as jnp
    from ndt_feature_graph_tpu.core import se2
    from ndt_feature_graph_tpu.graph import optimize as opt

    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    rels = jnp.concatenate(
        [
            jax.random.uniform(
                k1, (n_nodes - 1, 2), minval=-1.0, maxval=1.0
            ),
            jax.random.uniform(
                k1, (n_nodes - 1, 1), minval=-0.4, maxval=0.4
            ),
        ],
        -1,
    )
    gt = [jnp.zeros(3)]
    for r in rels:
        gt.append(se2.compose(gt[-1], r))
    gt = jnp.stack(gt)
    li = jax.random.randint(k2, (n_loop,), 0, n_nodes - 3)
    lj = li + jax.random.randint(k3, (n_loop,), 2, 3)
    lmeas = se2.sub(gt[li], gt[lj])
    i = jnp.concatenate([jnp.arange(n_nodes - 1), li]).astype(jnp.int32)
    j = jnp.concatenate([jnp.arange(1, n_nodes), lj]).astype(jnp.int32)
    meas = jnp.concatenate([rels, lmeas])
    info = jnp.tile(jnp.eye(3)[None] * 50.0, (i.shape[0], 1, 1))
    edges = opt.EdgeList(
        i=i, j=j, meas=meas, info=info,
        mask=jnp.ones(i.shape[0], bool),
    )
    noise = 0.1 * jax.random.normal(k3, gt.shape)
    init = gt + noise.at[0].set(0.0)
    return init, edges


def fleet_params():
    """Tiny canonical-shaped fuser config for the data-parallel fused
    scan leg (identical literal in test and workers)."""
    from ndt_feature_graph_tpu.config import FuserParams, NDTMapParams

    return FuserParams(
        ndt=NDTMapParams(
            resolution=0.5, size_x=20.0, size_y=20.0, sensor_range=8.0,
            max_points_per_scan=256, max_cells=128, ray_samples=16,
        )
    )


def link_params():
    """Tiny SLAM config for the sharded link-proposal leg (identical
    literal in test and workers; the test builds the node graph once
    and ships it to the workers as a checkpoint)."""
    from ndt_feature_graph_tpu.config import (
        FeatureParams, FuserParams, GraphParams, NDTMapParams,
        SLAMParams,
    )

    return SLAMParams(
        fuser=FuserParams(
            ndt=NDTMapParams(
                resolution=0.5, size_x=20.0, size_y=20.0,
                sensor_range=8.0, max_points_per_scan=256,
                max_cells=128, ray_samples=16,
            ),
            features=FeatureParams(num_beams=180, max_range=8.0),
        ),
        graph=GraphParams(new_node_transl_dist=2.0, max_nodes=12),
    )


def build_fleet_case(n_streams: int = 8, t_steps: int = 4):
    """Deterministic fleet inputs, identical on every rank."""
    from ndt_feature_graph_tpu.parallel import scaling

    return scaling.build_fleet_inputs(
        fleet_params(), n_streams, t_steps=t_steps, num_beams=180
    )


def link_pair_case(slam, n_slots: int = 16):
    """Fixed-size pair list from a loaded graph (identical everywhere)."""
    import jax.numpy as jnp
    import numpy as np

    ref, mov, mask = slam.candidate_pairs()
    n = int(ref.shape[0])
    r = np.zeros(n_slots, np.int32)
    m = np.zeros(n_slots, np.int32)
    mk = np.zeros(n_slots, bool)
    k = min(n, n_slots)
    r[:k] = np.asarray(ref)[:k]
    m[:k] = np.asarray(mov)[:k]
    mk[:k] = np.asarray(mask)[:k]
    return jnp.asarray(r), jnp.asarray(m), jnp.asarray(mk)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--graph", default="",
                    help="node-graph checkpoint for the links leg")
    args = ap.parse_args()

    import numpy as np

    from ndt_feature_graph_tpu.parallel import mesh as mesh_mod

    mesh_mod.init_distributed(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nprocs,
        process_id=args.rank,
    )
    assert jax.process_count() == args.nprocs
    mesh = mesh_mod.make_mesh_2d()
    assert mesh.shape["dcn"] == args.nprocs

    from ndt_feature_graph_tpu.graph import sparse_direct as sd
    from ndt_feature_graph_tpu.parallel import (
        solver_sharded, sparse_direct_sharded,
    )

    poses, edges = build_graph()
    axis = ("dcn", "ici")
    dense = solver_sharded.optimize_sharded(
        mesh, poses, edges, iterations=10, axis=axis
    )
    part = sd.make_segments(poses.shape[0], edges, max_seg_len=8)
    direct, chi = sparse_direct_sharded.optimize_direct_sharded(
        mesh, poses, edges, part, iterations=10, axis=axis
    )
    print(f"rank {args.rank} solvers done", flush=True)

    # --- data-parallel fused scan step across the 2-process mesh ---
    # (the fused per-scan pipeline itself must cross a real process
    # boundary, not just the solvers.)
    from jax.sharding import PartitionSpec as P
    from ndt_feature_graph_tpu.fusion import scan_driver

    fp = fleet_params()
    states, odom, pts, mask = build_fleet_case()
    spec = lambda x: P(axis, *([None] * (x.ndim - 1)))
    states_g = jax.tree.map(
        lambda x: mesh_mod.global_put(mesh, x, spec(x)), states
    )
    odom_g = mesh_mod.global_put(mesh, odom, spec(odom))
    pts_g = mesh_mod.global_put(mesh, pts, spec(pts))
    mask_g = mesh_mod.global_put(mesh, mask, spec(mask))

    @jax.jit
    def run_fleet(s, o, p_, m_):
        _finals, trajs, scores = (
            scan_driver.run_sequence_batch.__wrapped__(fp, s, o, p_, m_)
        )
        return trajs, scores

    trajs, scores = run_fleet(states_g, odom_g, pts_g, mask_g)
    trajs_l = mesh_mod.global_get(mesh, trajs)
    scores_l = mesh_mod.global_get(mesh, scores)
    print(f"rank {args.rank} fleet done", flush=True)

    # --- sharded link proposal across the 2-process mesh ---
    link_out = {}
    if args.graph:
        from ndt_feature_graph_tpu.graph import node as node_mod
        from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
        from ndt_feature_graph_tpu.parallel import links_sharded

        lp = link_params()
        slam = NDTFeatureGraphSLAM.load(args.graph, lp)
        stacked = node_mod.stack_nodes(slam.nodes)
        ref_i, mov_i, pmask = link_pair_case(slam)
        shard = links_sharded.compute_links_sharded(
            mesh, lp.fuser.features, lp.fuser.ndt.resolution, stacked,
            ref_i, mov_i, pmask, jax.random.PRNGKey(3), axis=axis,
        )
        link_out = {
            "link_T": mesh_mod.global_get(mesh, shard.T),
            "link_score": mesh_mod.global_get(mesh, shard.score),
            "link_mask": mesh_mod.global_get(mesh, shard.mask),
        }
        print(f"rank {args.rank} links done", flush=True)

    if args.rank == 0 and args.out:
        np.savez(
            args.out,
            dense=np.asarray(dense),
            direct=np.asarray(direct),
            chi=np.asarray(chi),
            fleet_trajs=trajs_l,
            fleet_scores=scores_l,
            **link_out,
        )
    print(f"rank {args.rank} done", flush=True)


if __name__ == "__main__":
    main()
