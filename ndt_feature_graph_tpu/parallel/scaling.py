"""Fleet scaling measurement: scans/s vs device count.

BASELINE.md config[4] machinery: shard a fleet of independent scan
streams over the mesh 'dp' axis (keyframe/stream partitioning —
SURVEY.md §7.9) and measure sustained throughput per device count.
On real multi-chip hardware this produces the ≥80% scaling-efficiency
figure; on the virtual CPU mesh it validates the sharded program
structure (tests) — the compiled program is identical either way.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ndt_feature_graph_tpu.config import FuserParams
from ndt_feature_graph_tpu.fusion import fuser, scan_driver
from ndt_feature_graph_tpu.io import dataset


def build_fleet_inputs(params: FuserParams, n_streams, t_steps=20,
                       num_beams=360, seed=0):
    traj = dataset.loop_trajectory(t_steps, radius=5.0)
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(seed), traj, num_beams=num_beams,
        max_range=params.ndt.sensor_range,
    )
    pts_all, mask_all = jax.vmap(dataset.scan_to_points)(
        seq.ranges, seq.hit
    )
    state = fuser.initialize(
        params, seq.gt[0], jnp.zeros(3), pts_all[0], mask_all[0]
    )
    states = jax.tree.map(
        lambda x: jnp.stack([x] * n_streams), state
    )
    # Perturb per-stream odometry so streams are distinct work.
    base = jnp.stack([seq.odom[1:]] * n_streams)
    jitter = 1e-4 * jnp.arange(n_streams)[:, None, None]
    odom = base + jitter
    pts = jnp.stack([pts_all[1:]] * n_streams)
    mask = jnp.stack([mask_all[1:]] * n_streams)
    return states, odom, pts, mask


def build_fleet_feature_inputs(params: FuserParams, n_streams,
                               t_steps=20, num_beams=360, seed=0):
    """Fleet inputs for the FULL-pipeline batch driver
    (run_sequence_features_batch): raw (ranges, hit) streams + batched
    FeatureFuserState, per-stream odometry jitter for distinct work."""
    from ndt_feature_graph_tpu.fusion import feature_fuser

    traj = dataset.loop_trajectory(t_steps, radius=5.0)
    seq = dataset.simulate_sequence(
        jax.random.PRNGKey(seed), traj, num_beams=num_beams,
        max_range=params.ndt.sensor_range,
    )
    state = feature_fuser.initialize(
        params, seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0],
        jax.random.PRNGKey(seed + 1),
    )
    states = jax.tree.map(
        lambda x: jnp.stack([x] * n_streams), state
    )
    # Distinct per-stream work: odometry jitter + per-stream PRNG keys.
    states = states._replace(
        key=jax.random.split(jax.random.PRNGKey(seed + 2), n_streams)
    )
    base = jnp.stack([seq.odom[1:]] * n_streams)
    jitter = 1e-4 * jnp.arange(n_streams)[:, None, None]
    odom = base + jitter
    ranges = jnp.stack([seq.ranges[1:]] * n_streams)
    hit = jnp.stack([seq.hit[1:]] * n_streams)
    return states, odom, ranges, hit


def measure_fleet_throughput(
    params: FuserParams,
    n_devices,
    streams_per_device=4,
    t_steps=20,
    reps=5,
):
    """Sustained scans/s with `n_devices` mesh shards.  Returns
    (scans_per_sec, per_rep_times)."""
    import numpy as np

    mesh = Mesh(
        np.asarray(jax.devices()[:n_devices]), ("dp",)
    )
    n_streams = n_devices * streams_per_device
    states, odom, pts, mask = build_fleet_inputs(
        params, n_streams, t_steps
    )

    def shard(x):
        return jax.device_put(
            x, NamedSharding(mesh, P("dp", *([None] * (x.ndim - 1))))
        )

    states = jax.tree.map(shard, states)
    odom, pts, mask = shard(odom), shard(pts), shard(mask)

    @jax.jit
    def run(states, odom, pts, mask):
        finals, trajs, scores = (
            scan_driver.run_sequence_batch.__wrapped__(
                params, states, odom, pts, mask
            )
        )
        # Scalar digest over EVERY output buffer, computed inside the
        # same executable; reading it back (float()) waits for all of
        # them with one transfer.
        digest = sum(
            jnp.sum(x.astype(jnp.float32))
            for x in jax.tree.leaves((finals, trajs, scores))
        )
        return digest

    # Warmup compiles AND is forced, so rep 1 measures steady state.
    float(run(states, odom, pts, mask))

    times = []
    for k in range(reps):
        odom_k = odom + (k + 1) * 1e-5
        t0 = time.perf_counter()
        float(run(states, odom_k, pts, mask))
        times.append(time.perf_counter() - t0)
    times.sort()
    per = times[len(times) // 2]
    scans = n_streams * (t_steps - 1)
    return scans / per, times


def scaling_report(params: FuserParams, device_counts, **kw):
    """Throughput + efficiency table over device counts."""
    rows = []
    base = None
    for n in device_counts:
        sps, _ = measure_fleet_throughput(params, n, **kw)
        if base is None:
            base = sps / n
        rows.append(
            {
                "devices": n,
                "scans_per_sec": round(sps, 1),
                "efficiency": round(sps / (n * base), 3),
            }
        )
    return rows


def serve_fleet_grouped(
    params: FuserParams, states, odom, pts, mask, group_size: int = 8
):
    """Serve a large fleet of independent scan streams in groups of
    `group_size` through scan_driver.run_sequence_batch.

    Streams are independent, so a fleet of R robots can be served as
    ceil(R/G) sequential G-stream groups, bounding the batch (and the
    shared gather bank) at G streams; this helper is that
    serving shape (the last partial group is padded by replicating
    stream 0 and its outputs dropped).

    Scheduling contract: groups run SEQUENTIALLY over their whole
    sequences — robot r in group k sees its first output only after k
    full group-sequences have finished, i.e. worst-case startup
    latency ~ (R/G - 1) * T * (per-scan group time).  Fine for batch
    replay; for live serving use serve_fleet_interleaved, which
    round-robins fixed time slices across groups so every stream
    advances at the aggregate rate continuously.

    Returns (final_states, trajectories (B, T-ish...), scores) shaped
    like run_sequence_batch over the whole fleet.
    """
    b = states.Tnow.shape[0]
    outs = []
    for s in range(0, b, group_size):
        e = min(s + group_size, b)
        pad = group_size - (e - s)

        def take(x):
            sl = x[s:e]
            if pad:
                sl = jnp.concatenate(
                    [sl, jnp.repeat(x[s:s + 1], pad, axis=0)]
                )
            return sl

        g_states = jax.tree.map(take, states)
        res = scan_driver.run_sequence_batch(
            params, g_states, take(odom), take(pts), take(mask)
        )
        outs.append(
            jax.tree.map(lambda x: x[: e - s], res)
        )
    return jax.tree.map(lambda *xs: jnp.concatenate(xs), *outs)


def serve_fleet_interleaved(
    params: FuserParams, states, odom, pts, mask,
    group_size: int = 8, time_chunk: int = 8,
):
    """serve_fleet_grouped with a PER-ROBOT LATENCY CONTRACT: instead
    of running each G-stream group over its whole sequence before the
    next group starts, fixed `time_chunk`-scan slices are round-robined
    across the ceil(R/G) groups — every stream advances by time_chunk
    scans each rotation, so per-robot progress is continuous at
    aggregate_rate/R scans/s and the worst-case staleness is one
    rotation (R/G - 1 group-chunks ~ (R/G-1) * time_chunk * per-scan
    group time), independent of sequence length.  Same executable as
    the grouped path (one compile: shapes are (G, time_chunk, ...)),
    same arithmetic per stream (the chunk boundary only splits the
    lax.scan — the carried FuserState is identical), so outputs match
    serve_fleet_grouped exactly (tests/test_parallel.py).

    Returns (final_states, trajectories, scores) like
    run_sequence_batch over the whole fleet.
    """
    b = states.Tnow.shape[0]
    t = odom.shape[1]
    n_groups = -(-b // group_size)

    # Per-group padded state/input slices.
    def take(x, s, e):
        pad = group_size - (e - s)
        sl = x[s:e]
        if pad:
            sl = jnp.concatenate(
                [sl, jnp.repeat(x[s:s + 1], pad, axis=0)]
            )
        return sl

    g_states = []
    bounds = []
    for gi in range(n_groups):
        s, e = gi * group_size, min((gi + 1) * group_size, b)
        bounds.append((s, e))
        g_states.append(
            jax.tree.map(lambda x: take(x, s, e), states)
        )

    chunks = [[] for _ in range(n_groups)]  # per group: (traj, score)
    for c0 in range(0, t, time_chunk):
        c1 = min(c0 + time_chunk, t)
        for gi, (s, e) in enumerate(bounds):
            res = scan_driver.run_sequence_batch(
                params, g_states[gi],
                take(odom[:, c0:c1], s, e),
                take(pts[:, c0:c1], s, e),
                take(mask[:, c0:c1], s, e),
            )
            g_states[gi], traj, scores = res
            chunks[gi].append((traj, scores))

    finals = jax.tree.map(
        lambda *xs: jnp.concatenate(xs)[:b],
        *[jax.tree.map(lambda x: x[: e - s], st)
          for (s, e), st in zip(bounds, g_states)],
    )
    trajs = jnp.concatenate(
        [
            jnp.concatenate([tc for tc, _ in chunks[gi]], axis=1)[
                : bounds[gi][1] - bounds[gi][0]
            ]
            for gi in range(n_groups)
        ],
        axis=0,
    )
    scores = jnp.concatenate(
        [
            jnp.concatenate([sc for _, sc in chunks[gi]], axis=1)[
                : bounds[gi][1] - bounds[gi][0]
            ]
            for gi in range(n_groups)
        ],
        axis=0,
    )
    return finals, trajs, scores
