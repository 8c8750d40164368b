"""Benchmark: sustained SLAM throughput (scans/s) on one chip at the
reference's canonical operating point (resolution 0.5 m, 100x100 m map,
30 m sensor range, 720-beam scans — launch/gustav_laser_tf.launch:11-23).

Headline: full_slam_scans_per_sec — the complete online graph-SLAM
pipeline (feature detect + describe + RANSAC + joint NDT/feature/
odometry fusion + map update + on-device node splits into the node
bank), fusion/scan_driver.run_graph_sequence, over a SUSTAINED 200-scan
gated sequence at realistic split density (~0.025 m/scan motion as if
gated at the reference's 0.02 m min-increment, node split every 2 m ->
a split every ~80 scans, publish_graph_message.cpp:316-345 geometry).

extra decomposition:
  - fuser_scans_per_sec: NDT-only scan-to-submap fusion
  - features_scans_per_sec: full feature pipeline, no graph wrapper
  - online_lc_scans_per_sec: chunked driver with online loop closure
    (host candidate loop + incremental solve at splits)
  - offline_pairs_per_sec: loop-closure proposal->refine->rescore
    throughput (the reference's O(N^2) offline hot loop,
    ndt_feature_graph_opt.cpp:152-174 / graph.cpp:395-405)
  - offline_solve_ms_570: segment-Schur LM solve latency on a
    570-node / ~4.3k-edge graph (12 iterations)

Measurement protocol: whole workloads inside jitted executables,
host-distinct inputs per rep, and a scalar digest that depends on every
output buffer read back to the host per rep (float()), which waits for
the device like block_until_ready does.  Median over reps.

The reference publishes no numbers (BASELINE.md); vs_baseline is
measured against the real-time bar the reference must sustain online —
50 scans/s (a 2D lidar's top scan rate; the reference gates updates at
0.02 m increments, publish_graph_message.cpp:316).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"extra"}.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.config import (
    FeatureParams, FuserParams, GraphParams, NDTMapParams, SLAMParams,
)
from ndt_feature_graph_tpu.fusion import fuser, scan_driver
from ndt_feature_graph_tpu.graph import node as node_mod
from ndt_feature_graph_tpu.graph import optimize as opt_mod
from ndt_feature_graph_tpu.graph import sparse_direct as sd
from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM
from ndt_feature_graph_tpu.io import dataset
from ndt_feature_graph_tpu.utils.compile_cache import enable_compile_cache

BASELINE_SCANS_PER_SEC = 50.0
T_STEPS = 200          # sustained gated sequence
STEP_M = 0.025         # per-scan motion (reference online min-incr gate)
SPLIT_M = 2.0          # node split distance -> a split every ~80 scans


MATCH_CELL_BUDGET = 256


def canonical_params():
    # match_cell_budget: the matcher reads only the first 256 compacted
    # source cells per scan — EXACT at this op point (a 720-beam scan
    # fills ~10-20% of the 1024-cell capacity; verify_cell_budget
    # checks every scan of the bench sequence before the budget is
    # trusted), and the window gather is the per-scan hot cost.
    # gather_window_cells/gather_block: the f32 WIN-BLOCK gather table
    # (one gathered row per source cell over a 136-cell sensor window)
    # — bit-exact vs the flat path on the CPU (tests).  The fleet
    # preset additionally uses bf16 rows (fleet_params below).
    return FuserParams(
        ndt=NDTMapParams(
            resolution=0.5,
            size_x=100.0,
            size_y=100.0,
            sensor_range=30.0,
            max_points_per_scan=720,
            max_cells=1024,
        ),
        features=FeatureParams(num_beams=720, max_range=30.0),
        match_cell_budget=MATCH_CELL_BUDGET,
        gather_window_cells=136,
        gather_block=True,
    )


def verify_cell_budget(params, seq):
    """HONESTY GATE for match_cell_budget: count every scan's valid
    local-NDT cells; the budget is only exact if no scan exceeds it.
    Returns (max_cells_seen, params) — falls back to the unbudgeted
    config if the bound fails (so the headline never silently
    truncates)."""
    pts_all, mask_all = jax.vmap(dataset.scan_to_points)(
        seq.ranges, seq.hit
    )

    @jax.jit
    def counts(pts, mask):
        def one(p, m):
            src, _ = fuser._build_local_cells(
                params, jnp.zeros(3), p, m
            )
            return jnp.sum(src.mask)

        return jax.vmap(one)(pts, mask)

    # Chunked: vmapping the local-grid build over a whole long
    # sequence at once OOMs the compile (1000 x 126x126 grid temps).
    t = pts_all.shape[0]
    chunk = 200
    mx = 0
    for c in range(0, t, chunk):
        if pts_all[c:c + chunk].shape[0] != chunk:
            tail_pts = pts_all[t - chunk:]
            tail_mask = mask_all[t - chunk:]
            mx = max(mx, int(jnp.max(counts(tail_pts, tail_mask))))
            break
        mx = max(
            mx,
            int(jnp.max(counts(pts_all[c:c + chunk],
                               mask_all[c:c + chunk]))),
        )
    if params.match_cell_budget and mx > params.match_cell_budget:
        return mx, params.replace(match_cell_budget=0)
    return mx, params


def make_sequence(t_steps=T_STEPS):
    # Slow corridor traverse: STEP_M per gated scan (as if the 0.02 m
    # online gate passed roughly every scan), total ~5 m -> 2 splits
    # at SPLIT_M=2 m, i.e. a split every ~80 scans.
    half = t_steps * STEP_M / 2.0
    traj = dataset.corridor_trajectory(t_steps, x0=-half, x1=half,
                                       y=-4.5)
    return dataset.simulate_sequence(
        jax.random.PRNGKey(0), traj, num_beams=720, max_range=30.0
    )


def median_time(fn, reps, *args):
    times = []
    for k in range(reps):
        t0 = time.perf_counter()
        fn(k)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def bench_fuser(params, seq, reps=8):
    """NDT-only fusion throughput (device-resident sequence driver)."""
    pts_all, mask_all = jax.vmap(dataset.scan_to_points)(
        seq.ranges, seq.hit
    )
    state = fuser.initialize(
        params, seq.gt[0], jnp.zeros(3), pts_all[0], mask_all[0]
    )

    @jax.jit
    def run(state, odom, pts, mask):
        final, traj, scores = scan_driver.run_sequence.__wrapped__(
            params, state, odom, pts, mask
        )
        digest = sum(
            jnp.sum(x.astype(jnp.float32))
            for x in jax.tree.leaves(final)
        )
        return traj, scores, digest

    odom = seq.odom[1:]
    t = seq.ranges.shape[0]
    out = run(state, odom, pts_all[1:], mask_all[1:])
    float(out[2])  # compile + wait

    def rep(k):
        out = run(state, odom + (k + 1) * 1e-5, pts_all[1:],
                  mask_all[1:])
        float(out[2])

    return (t - 1) / median_time(rep, reps)


def bench_features(params, seq, reps=6):
    """Full feature pipeline (detect + describe + RANSAC + joint
    fusion + map update), device-resident, no graph wrapper."""
    from ndt_feature_graph_tpu.fusion import feature_fuser

    state = feature_fuser.initialize(
        params, seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0],
        jax.random.PRNGKey(1),
    )

    @jax.jit
    def run(state, odom, ranges, hit):
        final, traj, scores = (
            scan_driver.run_sequence_features.__wrapped__(
                params, state, odom, ranges, hit
            )
        )
        digest = sum(
            jnp.sum(x.astype(jnp.float32))
            for x in jax.tree.leaves(final)
        )
        return traj, scores, digest

    odom = seq.odom[1:]
    t = seq.ranges.shape[0]
    out = run(state, odom, seq.ranges[1:], seq.hit[1:])
    float(out[2])  # compile + wait

    def rep(k):
        out = run(state, odom + (k + 1) * 1e-5, seq.ranges[1:],
                  seq.hit[1:])
        float(out[2])

    return (t - 1) / median_time(rep, reps)


def bench_full_slam(params, seq, reps=6):
    """HEADLINE: full online graph SLAM — feature pipeline + fusion +
    on-device node splits + graph maintenance, ALL inside one
    executable over the sequence (fusion/scan_driver.
    run_graph_sequence).  End-to-end wall time includes the
    trajectory/edge readbacks and the node-bank unstack
    (device-resident — node grids are NOT pulled to the host: that
    transfer is not part of the online loop's work).  The per-rep initial fuser state is
    precomputed once (host-side init amortized; the device init
    executable is shared)."""
    sparams = SLAMParams(
        fuser=params,
        graph=GraphParams(new_node_transl_dist=SPLIT_M, max_nodes=64),
    )
    t = seq.ranges.shape[0]

    # Shared initial device state across reps (identical by
    # construction: initialize() is deterministic given the seed).
    proto = NDTFeatureGraphSLAM(sparams, seed=0)
    proto.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    init_state, init_fmap, init_key = proto.state, proto.fmap, proto._key
    init_traj = [proto.trajectory[0].copy()]

    def run_once(odom):
        slam = NDTFeatureGraphSLAM(sparams, seed=0)
        slam.current_T = np.asarray(seq.gt[0], np.float32)
        slam.state, slam.fmap, slam._key = init_state, init_fmap, init_key
        slam.trajectory = list(init_traj)
        slam.times = [0.0]
        t0 = time.perf_counter()
        traj = slam.run_sequence_device(odom, seq.ranges, seq.hit)
        # Consumption: the trajectory (host numpy) depends on every
        # scan's outputs (the registration chain), so the whole scan
        # computation is forced; frozen nodes stay device-resident.
        assert np.isfinite(traj).all()
        dt = time.perf_counter() - t0
        return dt, len(slam.nodes)

    # Warmup: compiles run_graph_sequence + the bank prefix readback.
    run_once(seq.odom)
    times = []
    n_nodes = 0
    for k in range(reps):
        odom_k = seq.odom + (k + 1) * 1e-5
        dt, n_nodes = run_once(odom_k)
        times.append(dt)
    times.sort()
    return (t - 1) / times[len(times) // 2], n_nodes


# Fleet serving config: sensor-window-bounded WIN-BLOCK bf16 gather
# bank — one gathered row per source cell over a 136-cell window
# around the predicted pose, plus in-place scatters and touched-only
# local compaction.  The occupancy ray scatter at serving cadence
# (occ_every=4 — poses bit-identical, occupancy accumulates 1/4 as
# fast) is reported as an extra field; the headline fleet curve keeps
# per-scan occupancy (reference parity).
FLEET_SIZES = (8, 32, 64)
FLEET_T = 40


def fleet_params(params):
    return params.replace(
        gather_window_cells=136, gather_table_bf16=True,
        gather_block=True,
    )


def bench_fleet(params, reps=3):
    """Fleet serving: B independent scan streams (one robot each)
    fused in ONE executable on the one chip
    (scan_driver.run_sequence_batch) — the batched answer to the
    reference's process-per-robot model (publish_graph_message.cpp).
    Reports aggregate scans/s per batch size.

    Stream content caveat: streams replicate one simulated sequence
    with per-stream odometry jitter — distinct WORK per lane is
    guaranteed (jitter perturbs every registration), but identical
    scan content is the friendliest cache/layout case, and 40-step
    streams under-amortize fixed dispatch cost.
    """
    from ndt_feature_graph_tpu.parallel import scaling

    fp = fleet_params(params)
    curve = {}
    for B in FLEET_SIZES:
        states, odom, pts, mask = scaling.build_fleet_inputs(
            fp, B, t_steps=FLEET_T, num_beams=720
        )

        @jax.jit
        def run(states, odom, pts, mask):
            finals, trajs, scores = (
                scan_driver.run_sequence_batch.__wrapped__(
                    fp, states, odom, pts, mask
                )
            )
            return sum(
                jnp.sum(x.astype(jnp.float32))
                for x in jax.tree.leaves((finals, trajs, scores))
            )

        float(run(states, odom, pts, mask))  # compile + force

        def rep(k):
            float(run(states, odom + (k + 1) * 1e-5, pts, mask))

        t = median_time(rep, reps)
        curve[B] = B * (FLEET_T - 1) / t

    # Serving-cadence extra: occupancy every 4th scan (poses
    # bit-identical — tests/test_scan_driver.py).
    B = 32
    fp4 = fp.replace(occ_every=4)
    states, odom, pts, mask = scaling.build_fleet_inputs(
        fp4, B, t_steps=FLEET_T, num_beams=720
    )

    @jax.jit
    def run4(states, odom, pts, mask):
        finals, trajs, scores = (
            scan_driver.run_sequence_batch.__wrapped__(
                fp4, states, odom, pts, mask
            )
        )
        return sum(
            jnp.sum(x.astype(jnp.float32))
            for x in jax.tree.leaves((finals, trajs, scores))
        )

    float(run4(states, odom, pts, mask))

    def rep4(k):
        float(run4(states, odom + (k + 1) * 1e-5, pts, mask))

    occ4 = B * (FLEET_T - 1) / median_time(rep4, reps)
    return curve, occ4


def bench_fleet_full(params, reps=3, sizes=(8, 32)):
    """FULL-pipeline fleet serving: B independent streams of the
    feature-aware pipeline (detect + describe + RANSAC + joint
    NDT/feature/odometry fusion + map update) in ONE executable
    (scan_driver.run_sequence_features_batch) — the multi-robot
    serving shape of the reference's whole per-robot online node
    (publish_graph_message.cpp:1259-1628).  Reports aggregate scans/s
    per batch size."""
    from ndt_feature_graph_tpu.parallel import scaling

    fp = fleet_params(params)
    curve = {}
    for B in sizes:
        states, odom, ranges, hit = (
            scaling.build_fleet_feature_inputs(
                fp, B, t_steps=FLEET_T, num_beams=720
            )
        )

        @jax.jit
        def run(states, odom, ranges, hit):
            finals, trajs, scores = (
                scan_driver.run_sequence_features_batch.__wrapped__(
                    fp, states, odom, ranges, hit
                )
            )
            return sum(
                jnp.sum(x.astype(jnp.float32))
                for x in jax.tree.leaves((finals, trajs, scores))
            )

        float(run(states, odom, ranges, hit))

        def rep(k):
            float(run(states, odom + (k + 1) * 1e-5, ranges, hit))

        t = median_time(rep, reps)
        curve[B] = B * (FLEET_T - 1) / t
    return curve


def bench_online_lc(params, seq, reps=3):
    """Chunked driver + online loop closure: the host-involved mode
    (candidate RANSAC/D2D + incremental solve at node splits) —
    run_sequence_chunked, graph/slam.py online-closure path."""
    sparams = SLAMParams(
        fuser=params,
        graph=GraphParams(
            new_node_transl_dist=SPLIT_M, max_nodes=64,
            online_loop_closure=True, valid_min_idx_dist=1,
            online_lc_candidate_dist=20.0,
        ),
    )
    t = seq.ranges.shape[0]

    def run_once(odom):
        slam = NDTFeatureGraphSLAM(sparams, seed=0)
        slam.initialize(
            seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0]
        )
        t0 = time.perf_counter()
        traj = slam.run_sequence_chunked(
            odom, seq.ranges, seq.hit, chunk=64
        )
        assert np.isfinite(traj).all()
        return time.perf_counter() - t0

    run_once(seq.odom)
    times = []
    for k in range(reps):
        times.append(run_once(seq.odom + (k + 1) * 1e-5))
    times.sort()
    return (t - 1) / times[len(times) // 2]


def bench_offline(params, seq, reps=3):
    """Offline-phase metrics (the reference's second hot loop,
    ndt_feature_graph_opt.cpp:152-174):
      - pairs/s through propose (feature RANSAC) -> D2D refine ->
        overlap rescore, one 256-pair batch of real node data;
      - segment-Schur LM solve latency on a synthetic 570-node
        multi-loop graph (solve cost depends only on graph structure).
    """
    from ndt_feature_graph_tpu.graph import links as links_mod

    # Build a denser graph from the same sequence (split every 0.25 m
    # -> ~20 nodes) for real pair data.
    sparams = SLAMParams(
        fuser=params,
        graph=GraphParams(new_node_transl_dist=0.25, max_nodes=64),
    )
    slam = NDTFeatureGraphSLAM(sparams, seed=0)
    slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    slam.run_sequence_device(seq.odom, seq.ranges, seq.hit)
    slam.finalize_current_node()
    n = len(slam.nodes)
    stacked = node_mod.stack_nodes(slam.nodes)

    pairs = [(i, j) for i in range(n) for j in range(i + 2, n)]
    p = sparams.fuser
    budget = links_mod.source_cell_budget(stacked)

    def pairs_rate(B):
        """pairs/s at batch width B (propose -> refine -> rescore)."""
        reps_idx = np.resize(np.asarray(pairs, np.int32), (B, 2))
        ref = jnp.asarray(reps_idx[:, 0])
        mov = jnp.asarray(reps_idx[:, 1])
        mask = jnp.ones(B, bool)

        def propose(key):
            ls = links_mod.compute_links_batch(
                p.features, p.ndt.resolution, stacked, ref, mov, mask,
                key,
            )
            ls = links_mod.refine_links_d2d(
                p.ndt, p.matcher, stacked, ls, src_budget=budget
            )
            ls = links_mod.rescore_links(p.ndt.resolution, stacked, ls)
            # Scalar digest over every output buffer, read back
            # (forcing).
            return jnp.sum(ls.T) + jnp.sum(ls.score) + jnp.sum(ls.cov)

        float(propose(jax.random.PRNGKey(0)))

        def rep(k):
            float(propose(jax.random.PRNGKey(k + 1)))

        return B / median_time(rep, reps)

    pairs_curve = {B: pairs_rate(B) for B in (256, 1024)}
    pairs_per_sec = max(pairs_curve.values())

    # Solve latency at 570 nodes: synthetic multi-loop pose graph.
    n_nodes = 570
    init, edges = multi_loop_graph(n_nodes)
    part = sd.make_segments(n_nodes, edges, max_seg_len=64)
    out = sd.optimize_direct(init, edges, part, iterations=12,
                             robust_kernel="dcs")
    float(jnp.sum(out[0]) + out[1])

    def rep2(k):
        out = sd.optimize_direct(
            init + (k + 1) * 1e-6, edges, part, iterations=12,
            robust_kernel="dcs",
        )
        float(jnp.sum(out[0]) + out[1])

    solve_ms = median_time(rep2, reps) * 1e3
    return pairs_per_sec, pairs_curve, solve_ms, int(edges.i.shape[0])


def multi_loop_graph(n_nodes=570, seed=0):
    """Synthetic 8-revolution pose graph: an odometry chain plus one
    loop edge from every node to the node a revolution later, 1 cm
    measurement noise, 5 cm initial-pose noise.  Returns
    (init (N, 3), EdgeList).  Solve cost depends only on this
    structure."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 8 * 2 * np.pi, n_nodes)
    gt = np.stack(
        [5 * np.cos(th), 5 * np.sin(th), np.zeros(n_nodes)], -1
    ).astype(np.float32)
    ei = list(range(n_nodes - 1))
    ej = list(range(1, n_nodes))
    per_loop = n_nodes // 8
    li = np.arange(0, n_nodes - per_loop - 2)
    lj = li + per_loop
    i = np.concatenate([ei, li]).astype(np.int32)
    j = np.concatenate([ej, lj]).astype(np.int32)
    meas = np.zeros((i.shape[0], 3), np.float32)
    for k in range(i.shape[0]):
        d = gt[j[k]] - gt[i[k]]
        c, s = np.cos(gt[i[k], 2]), np.sin(gt[i[k], 2])
        meas[k] = [c * d[0] + s * d[1], -s * d[0] + c * d[1],
                   d[2]]
    meas += rng.normal(0, 0.01, meas.shape).astype(np.float32)
    info = np.tile(np.eye(3, dtype=np.float32)[None] * 100.0,
                   (i.shape[0], 1, 1))
    edges = opt_mod.EdgeList(
        i=jnp.asarray(i), j=jnp.asarray(j),
        meas=jnp.asarray(meas), info=jnp.asarray(info),
        mask=jnp.ones(i.shape[0], bool),
    )
    init = jnp.asarray(
        gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    )
    return init, edges


def bench_offline_570(params, n_loops=10, steps_per_loop=704,
                      radius=2.8, max_nodes=600, k_pairs=512):
    """Offline phase AT THE SCALE IT WAS BUILT FOR: build a ~570-node graph at the CANONICAL op point through the
    device-resident driver (10 tight loops, node split every 0.25 m,
    ~7k scans; measured 459 nodes at 8 loops -> ~570 at 10), then
    measure against the real multi-GB node bank:
      - link-proposal pairs/s, grouped (link_group_nodes=16) vs plain
        chunked, same 512 candidate pairs (the grouped path exists
        precisely because the refine gathers' working set must stay
        small when the bank is huge);
      - ONE end-to-end offline wall clock (propose -> refine ->
        rescore -> fixpoint validate+solve) with grouping at the
        winner.
    Returns a dict of extra fields.
    """
    import time as _time

    from ndt_feature_graph_tpu.graph import node as g_node

    sparams = SLAMParams(
        fuser=params,
        graph=GraphParams(
            new_node_transl_dist=0.25,
            max_nodes=max_nodes,
            max_links=8192,
            valid_min_idx_dist=25,
            offline_candidate_dist=1.0,
            link_batch_size=256,
            valid_max_dist=1.0,
            valid_max_angular_dist=0.4,
            valid_max_score=0.2,
            solver="auto",
            solver_dense_max_nodes=256,
            solver_max_seg_len=64,
            gn_iterations=12,
            fixpoint_max_rounds=3,
        ),
    )
    traj = dataset.multi_loop_trajectory(
        n_loops=n_loops, steps_per_loop=steps_per_loop, radius=radius
    )
    seq570 = dataset.simulate_sequence(
        jax.random.PRNGKey(3), traj,
        num_beams=params.features.num_beams,
        max_range=params.ndt.sensor_range,
        odom_noise=(0.004, 0.004, 0.002),
    )
    slam = NDTFeatureGraphSLAM(sparams, seed=0)
    slam.initialize(
        seq570.gt[0], jnp.zeros(3), seq570.ranges[0], seq570.hit[0]
    )
    t0 = time.perf_counter()
    slam.run_sequence_device(seq570.odom, seq570.ranges, seq570.hit)
    slam.finalize_current_node()
    build_wall = time.perf_counter() - t0
    n = len(slam.nodes)
    stacked = g_node.stack_nodes(slam.nodes)
    ref, mov, mask = slam.candidate_pairs()
    ncand = int(np.asarray(mask).sum())

    # Grouped vs plain pairs/s on the same 512-pair slice of the real
    # (locality-sorted) candidate list against the full-size bank.
    k = min(k_pairs, ncand)
    rates = {}
    for gname, gn in (("plain", 0), ("grouped", 16)):
        slam.params = sparams.replace(
            graph=sparams.graph.replace(link_group_nodes=gn)
        )
        def run_prop():
            t0 = time.perf_counter()
            ls = slam._propose_links(
                stacked, ref[:k], mov[:k], mask[:k]
            )
            # Readback waits for the device.
            float(jnp.sum(ls.T) + jnp.sum(ls.score))
            return time.perf_counter() - t0
        run_prop()            # warm (compile)
        rates[gname] = k / run_prop()

    winner = "grouped" if rates["grouped"] >= rates["plain"] else "plain"
    slam.params = sparams.replace(
        graph=sparams.graph.replace(
            link_group_nodes=16 if winner == "grouped" else 0
        )
    )
    t0 = time.perf_counter()
    node_T = np.asarray(slam.optimize_offline())
    offline_wall = time.perf_counter() - t0
    assert np.isfinite(node_T).all()

    return {
        "offline_nodes_built_570": n,
        "offline_build_scans_per_sec_570": round(
            (seq570.gt.shape[0] - 1) / build_wall, 2
        ),
        "offline_candidates_570": ncand,
        "offline_pairs_per_sec_570_plain": round(rates["plain"], 2),
        "offline_pairs_per_sec_570_grouped": round(rates["grouped"], 2),
        "offline_pairs_winner_570": winner,
        "offline_wall_s_570": round(offline_wall, 2),
    }


def main():
    enable_compile_cache()
    params = canonical_params()
    seq = make_sequence()
    max_cells_seen, params = verify_cell_budget(params, seq)
    fuser_sps = bench_fuser(params, seq)
    features_sps = bench_features(params, seq)
    full_sps, n_nodes = bench_full_slam(params, seq)
    online_lc_sps = bench_online_lc(params, seq)
    pairs_ps, pairs_curve, solve_ms, n_edges = bench_offline(params, seq)
    extra_570 = bench_offline_570(params)
    fleet_curve, fleet_occ4 = bench_fleet(params)
    fleet_best = max(fleet_curve.values())
    fleet_full_curve = bench_fleet_full(params)
    fleet_full_best = max(fleet_full_curve.values())
    print(
        json.dumps(
            {
                "metric": "full_slam_scans_per_sec",
                "value": round(full_sps, 2),
                "unit": "scans/s",
                "vs_baseline": round(full_sps / BASELINE_SCANS_PER_SEC, 3),
                "extra": {
                    "fuser_scans_per_sec": round(fuser_sps, 2),
                    "features_scans_per_sec": round(features_sps, 2),
                    "online_lc_scans_per_sec": round(online_lc_sps, 2),
                    "offline_pairs_per_sec": round(pairs_ps, 2),
                    "offline_pairs_curve": {
                        str(b): round(v, 2)
                        for b, v in pairs_curve.items()
                    },
                    "offline_solve_ms_570_nodes": round(solve_ms, 2),
                    "offline_solve_edges": n_edges,
                    "fleet_scans_per_sec": round(fleet_best, 2),
                    "fleet_curve": {
                        str(b): round(v, 2)
                        for b, v in fleet_curve.items()
                    },
                    "fleet_scans_per_sec_occ4": round(fleet_occ4, 2),
                    "fleet_full_scans_per_sec": round(
                        fleet_full_best, 2
                    ),
                    "fleet_full_curve": {
                        str(b): round(v, 2)
                        for b, v in fleet_full_curve.items()
                    },
                    **extra_570,
                    "nodes_built": n_nodes,
                    "t_steps": T_STEPS,
                    "match_cell_budget": params.match_cell_budget,
                    "max_scan_cells_seen": max_cells_seen,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
