"""On-card smoke test of the canonical graph-SLAM path.

Drives the system once, in one process, through the entry points a user
calls, at the reference's canonical operating point (0.5 m cells,
100x100 m map, 30 m range, 720 beams, max_cells 1024, win-block gather
table, match_cell_budget 256 — models.presets.feature_graph_slam and
bench.canonical_params), and checks each phase against the repo's plain
reference.  It needs a GPU: with none it exits non-zero before printing
any result.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded phase only

Phases (one card): device, registration (analytic fast path vs the
autodiff oracle, at the program's own precision and at "highest"),
online graph SLAM (cli simulate/slam/eval and run_sequence_device
against CPU-measured ATE bounds), fleet (bf16 win-block batch vs the
f32 block path, plus one full-pipeline batch step), offline solve
(segment-Schur direct solver vs the dense solver, 570 nodes).

Each phase prints one line with its wall time, its compile time and
every deviation beside its tolerance.  The last line of standard output
is the JSON result {"ok": true, "device": {...}}, printed only when
every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

# ATE of each online-SLAM run on the CPU (jax_platforms=cpu, default
# matmul precision, same seeds and sizes), and the margin the card may
# add.  Registration on the card sums in another order (atomic scatter-
# adds, other reduction trees).  On the CPU, perturbing the inputs by
# 1e-5 m moves these ATEs by at most 1 mm; 2 cm (4% of a cell) is far
# above that and far below a failed registration (decimetres).
CPU_ATE_M = {
    "cli_slam": 0.0919,
    "device_driver": 0.1374,
}
ATE_MARGIN_M = 0.02

SIM_STEPS_PER_LAP = 100
SIM_LAPS = 2
FLEET_B = 8
FLEET_T = 40
# bf16 win-block rows quantize cell-relative means at resolution/256
# = 2 mm; on the CPU these 8 canonical streams end 2.1 mm (max over all
# poses) from the f32 path.
FLEET_POSE_TOL_M = 5e-3
SOLVE_NODES = 570
SOLVE_ITERS = 20
# Max abs over all nodes, m and rad: the two solvers agree to 4.5e-4 on
# the CPU (f32 normal equations of a 570-node chain, one soft anchor).
SOLVE_POSE_TOL = 2e-3
SOLVE_CHI2_RTOL = 1e-3
# Fast-path vs oracle, each normalised by the oracle's largest entry.
# f32 sums over the 256x25 pairs of one scan agree to ~1e-6 on the CPU;
# TF32 products (10-bit mantissa) would show up near 1e-3.
REG_TOL = 1e-4


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.total += duration


class Check:
    """Deviations of one phase, each against its tolerance."""

    def __init__(self):
        self.items = []

    def le(self, name, value, tol, note=""):
        value = float(value)
        ok = bool(np.isfinite(value) and value <= tol)
        self.items.append((name, value, tol, note, ok))

    def true(self, name, cond, note=""):
        self.items.append((name, bool(cond), None, note, bool(cond)))

    @property
    def ok(self):
        return all(it[-1] for it in self.items)

    def text(self):
        out = []
        for name, value, tol, note, ok in self.items:
            mark = "" if ok else " FAIL"
            if tol is None:
                s = f"{name}={value}{mark}"
            else:
                s = f"{name}={value:.3e}<={tol:.1e}{mark}"
            out.append(s + (f" ({note})" if note else ""))
        return "; ".join(out)


def require_gpu():
    """The devices, or exit non-zero: this script never falls back to
    the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
            file=sys.stderr,
        )
        sys.exit(2)
    return devs


def result_line(devs) -> str:
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    })


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


# ---------------------------------------------------------------- phases


def phase_device(chk, devs):
    print(f"platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}")
    lines = card_lines()
    for ln in lines:
        print(ln)
    chk.true("nvidia_smi_cards", len(lines) >= 1)


def registration_case(t_scan=20):
    """Canonical registration inputs: the fuser state after scan 0 of
    the bench sequence and scan `t_scan`'s local NDT (256-cell budget)
    at the odometry-predicted pose."""
    import bench
    from ndt_feature_graph_tpu.core import se2
    from ndt_feature_graph_tpu.fusion import fuser
    from ndt_feature_graph_tpu.io import dataset

    params = bench.canonical_params()
    seq = bench.make_sequence()
    pts0, m0 = dataset.scan_to_points(seq.ranges[0], seq.hit[0])
    state = fuser.initialize(params, seq.gt[0], jnp.zeros(3), pts0, m0)
    pts, mask = dataset.scan_to_points(seq.ranges[t_scan], seq.hit[t_scan])
    src, _ = fuser._build_local_cells(params, state.sensor_pose, pts, mask)
    nb = params.match_cell_budget
    src = jax.tree.map(lambda x: x[:nb], src)
    motion = se2.sub(seq.gt[0], seq.gt[t_scan])
    T_pred = se2.compose(state.Tnow, motion)
    return params, state, src, T_pred


def registration_fns(params):
    """Jitted (fast, oracle): each maps (d, T_pred, src, packed, origin)
    to (f, g, H).  The fast path runs exactly as fuser.update calls it
    (win-block table, B=1); the oracle is autodiff of the dense cost."""
    from ndt_feature_graph_tpu.ops import d2d, d2d_analytic

    m = params.matcher
    h, w = params.ndt.grid_h, params.ndt.grid_w
    res = params.ndt.resolution
    wc = params.gather_window_cells

    @jax.jit
    def fast(d, T_pred, src, packed, origin):
        blk, cell0 = d2d.build_window_block_tables(
            packed[None], origin[None], T_pred[None, :2], h, w,
            m.n_neighbours, wc, res, bf16=params.gather_table_bf16,
        )
        f, g, H = d2d_analytic.fgh_dense_block_batch(
            d[None], T_pred[None], jax.tree.map(lambda x: x[None], src),
            blk.reshape(-1, blk.shape[-1]), cell0, origin[None], wc, res,
            m, rel_means=params.gather_table_bf16,
        )
        return f[0], g[0], H[0]

    @jax.jit
    def oracle(d, T_pred, src, packed, origin):
        def score(dd):
            return d2d.d2d_score_dense_flat(
                dd, T_pred, src, packed, origin, 0, h, w, res, m
            )

        return score(d), jax.grad(score)(d), jax.hessian(score)(d)

    return fast, oracle


REG_INCREMENTS = (
    (0.0, 0.0, 0.0),
    (0.05, -0.03, 0.02),
    (-0.2, 0.15, -0.12),
)


def phase_registration(chk):
    """Fast path at the program's own precision and at "highest",
    each against the autodiff oracle evaluated at "highest" (a plain
    reference computes at full float32)."""
    params, state, src, T_pred = registration_case()
    fast, oracle = registration_fns(params)
    n_valid = int(jnp.sum(src.mask))
    chk.true("valid_source_cells_within_budget",
             0 < n_valid <= params.match_cell_budget,
             f"{n_valid} of {params.match_cell_budget}")
    cases = [
        (jnp.asarray(d, jnp.float32), T_pred, src, state.packed,
         state.grid.origin)
        for d in REG_INCREMENTS
    ]
    with jax.default_matmul_precision("highest"):
        ref = [oracle(*args) for args in cases]
    for prec_name, ctx in (
        ("default", contextlib.nullcontext()),
        ("highest", jax.default_matmul_precision("highest")),
    ):
        dev = {"f": 0.0, "g": 0.0, "H": 0.0}
        with ctx:
            for args, (f0, g0, H0) in zip(cases, ref):
                f, g, H = fast(*args)
                dev["f"] = max(dev["f"], _rel(f, f0))
                dev["g"] = max(dev["g"], _rel(g, g0))
                dev["H"] = max(dev["H"], _rel(H, H0))
        for k, v in dev.items():
            chk.le(f"{k}_rel_dev_{prec_name}", v, REG_TOL,
                   f"fast path at {prec_name}, oracle at highest")


def _run_cli(argv):
    from ndt_feature_graph_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def _json_lines(text):
    out = []
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("{") and ln.endswith("}"):
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                pass      # the pipeline's verbose dict print
    return out


def run_cli_slam(workdir):
    """cli simulate (two laps) -> cli slam --optimize -> cli eval.
    Returns (slam stats, eval result, validated loop links)."""
    seq_path = os.path.join(workdir, "seq.npz")
    out_dir = os.path.join(workdir, "run")
    _run_cli([
        "simulate", "--out", seq_path, "--laps", str(SIM_LAPS),
        "--steps", str(SIM_STEPS_PER_LAP), "--num-beams", "720",
        "--sensor-range", "30", "--seed", "0",
    ])
    text = _run_cli([
        "slam", "--dataset", seq_path, "--out", out_dir, "--optimize",
        "--map-size", "100", "--sensor-range", "30", "--num-beams", "720",
        "--max-cells", "1024",
    ])
    stats = _json_lines(text)[-1]
    links = [
        int(ln.split(":")[1].split()[0])
        for ln in text.splitlines() if ln.startswith("fixpoint round")
    ]
    ev = _json_lines(_run_cli([
        "eval", "--est", os.path.join(out_dir, "est.tum"),
        "--gt", os.path.join(out_dir, "gt.tum"),
    ]))[-1]
    return stats, ev, (links[-1] if links else 0)


def device_driver():
    """A callable running NDTFeatureGraphSLAM.run_sequence_device on the
    bench sequence at the canonical params; it returns (ATE m, nodes,
    seconds inside run_sequence_device)."""
    import bench
    from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM

    seq = bench.make_sequence()
    gt = np.asarray(seq.gt)
    sparams = SLAMParams(
        fuser=bench.canonical_params(),
        graph=GraphParams(new_node_transl_dist=bench.SPLIT_M, max_nodes=64),
    )

    def once():
        slam = NDTFeatureGraphSLAM(sparams, seed=0)
        slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
        t0 = time.perf_counter()
        traj = slam.run_sequence_device(seq.odom, seq.ranges, seq.hit)
        dt = time.perf_counter() - t0
        ate = np.sqrt(np.mean(np.sum((traj[:, :2] - gt[:, :2]) ** 2, -1)))
        return float(ate), len(slam.nodes), dt

    return once


def device_busy(fn):
    """Run fn() under the profiler; returns (GPU 0 busy s, wall s)."""
    from ndt_feature_graph_tpu.utils.timers import device_busy_s

    tmp = tempfile.mkdtemp(prefix="ndtg_trace_")
    try:
        with jax.profiler.trace(tmp):
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        return device_busy_s(tmp), wall
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_online(chk):
    tmp = tempfile.mkdtemp(prefix="ndtg_smoke_")
    try:
        stats, ev, links = run_cli_slam(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bound = CPU_ATE_M["cli_slam"] + ATE_MARGIN_M
    chk.le("cli_slam_ate_m", stats["ate_rmse_m"], bound,
           f"CPU {CPU_ATE_M['cli_slam']:.4f} + {ATE_MARGIN_M}")
    chk.le("cli_eval_ate_m", ev["ate_rmse_m"], bound)
    chk.true("cli_slam_nodes", stats["n_nodes"] > 2, stats["n_nodes"])
    chk.true("validated_loop_links", links >= 1, links)
    run = device_driver()
    run()
    ate, nodes, dt = run()
    bound = CPU_ATE_M["device_driver"] + ATE_MARGIN_M
    chk.le("device_driver_ate_m", ate, bound,
           f"CPU {CPU_ATE_M['device_driver']:.4f} + {ATE_MARGIN_M}")
    chk.true("device_driver_nodes", nodes >= 2, nodes)
    busy, wall = device_busy(run)
    print(f"online: run_sequence_device warm {dt:.3f} s for 199 scans; "
          f"traced run {wall:.3f} s, GPU busy {busy:.3f} s, "
          f"idle share {1.0 - busy / max(wall, 1e-9):.3f}", flush=True)


def fleet_inputs(params, b, t_steps):
    from ndt_feature_graph_tpu.parallel import scaling

    return scaling.build_fleet_inputs(
        params, b, t_steps=t_steps, num_beams=720
    )


def run_fleet(params, inputs):
    from ndt_feature_graph_tpu.fusion import scan_driver

    _finals, trajs, scores = scan_driver.run_sequence_batch(
        params, *inputs
    )
    return np.asarray(trajs), np.asarray(scores)


def phase_fleet(chk):
    from ndt_feature_graph_tpu.fusion import scan_driver
    from ndt_feature_graph_tpu.models import presets
    from ndt_feature_graph_tpu.parallel import scaling

    fp = presets.fleet_serving()
    inputs = fleet_inputs(fp, FLEET_B, FLEET_T)
    t16, s16 = run_fleet(fp, inputs)
    t32, s32 = run_fleet(fp.replace(gather_table_bf16=False), inputs)
    chk.true("fleet_finite", np.isfinite(t16).all() and np.isfinite(t32).all())
    chk.le("fleet_bf16_vs_f32_pose_m", np.max(np.abs(t16 - t32)[..., :2]),
           FLEET_POSE_TOL_M, f"B={FLEET_B}, {FLEET_T} scans")
    chk.le("fleet_bf16_vs_f32_heading_rad", np.max(np.abs(t16 - t32)[..., 2]),
           FLEET_POSE_TOL_M)
    states, odom, ranges, hit = scaling.build_fleet_feature_inputs(
        fp, FLEET_B, t_steps=2, num_beams=720
    )
    _f, trajs, _s = scan_driver.run_sequence_features_batch(
        fp, states, odom, ranges, hit
    )
    trajs = np.asarray(trajs)
    chk.true("features_batch_step_finite",
             trajs.shape == (FLEET_B, 1, 3) and np.isfinite(trajs).all(),
             trajs.shape)


def solve_pair(iterations=SOLVE_ITERS, robust_kernel="dcs"):
    import bench
    from ndt_feature_graph_tpu.graph import optimize as opt
    from ndt_feature_graph_tpu.graph import sparse_direct as sd

    init, edges = bench.multi_loop_graph(SOLVE_NODES)
    part = sd.make_segments(SOLVE_NODES, edges, max_seg_len=64)
    direct = sd.optimize_direct(init, edges, part, iterations=iterations,
                                robust_kernel=robust_kernel)
    dense = opt.optimize(init, edges, iterations=iterations,
                         robust_kernel=robust_kernel)
    return (np.asarray(direct[0]), float(direct[1]),
            np.asarray(dense[0]), float(dense[1]))


def phase_solve(chk):
    p_d, c_d, p_n, c_n = solve_pair()
    chk.le("direct_vs_dense_pose", np.max(np.abs(p_d - p_n)),
           SOLVE_POSE_TOL, f"{SOLVE_NODES} nodes, {SOLVE_ITERS} iterations")
    chk.le("direct_vs_dense_chi2_rel", abs(c_d - c_n) / max(abs(c_n), 1e-9),
           SOLVE_CHI2_RTOL, f"chi2 {c_d:.4f} vs {c_n:.4f}")


def link_nodes():
    """A stacked node bank from the bench sequence at a 0.25 m split,
    and every node pair at least two apart, padded to a multiple of 4."""
    import bench
    from ndt_feature_graph_tpu.config import GraphParams, SLAMParams
    from ndt_feature_graph_tpu.graph import node as node_mod
    from ndt_feature_graph_tpu.graph.slam import NDTFeatureGraphSLAM

    seq = bench.make_sequence()
    sparams = SLAMParams(
        fuser=bench.canonical_params(),
        graph=GraphParams(new_node_transl_dist=0.25, max_nodes=64),
    )
    slam = NDTFeatureGraphSLAM(sparams, seed=0)
    slam.initialize(seq.gt[0], jnp.zeros(3), seq.ranges[0], seq.hit[0])
    slam.run_sequence_device(seq.odom, seq.ranges, seq.hit)
    slam.finalize_current_node()
    n = len(slam.nodes)
    pairs = [(i, j) for i in range(n) for j in range(i + 2, n)]
    pad = (-len(pairs)) % 4
    ref = np.asarray([p[0] for p in pairs] + [0] * pad, np.int32)
    mov = np.asarray([p[1] for p in pairs] + [1] * pad, np.int32)
    mask = np.asarray([True] * len(pairs) + [False] * pad)
    return (sparams.fuser, node_mod.stack_nodes(slam.nodes),
            jnp.asarray(ref), jnp.asarray(mov), jnp.asarray(mask))


def phase_four_cards(chk, devs):
    """Three sharded programs on a 4-card 'dp' mesh, each beside the
    same work on one card."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ndt_feature_graph_tpu.fusion import scan_driver
    from ndt_feature_graph_tpu.graph import links as links_mod
    from ndt_feature_graph_tpu.graph import sparse_direct as sd
    from ndt_feature_graph_tpu.models import presets
    from ndt_feature_graph_tpu.parallel import links_sharded
    from ndt_feature_graph_tpu.parallel import sparse_direct_sharded
    import bench

    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    mesh = Mesh(np.asarray(devs[:4]), ("dp",))
    one = devs[0]

    # Cheapest first, each result printed as it lands, so a run cut
    # short still reports what finished.  Segment-sharded direct solve
    # vs the one-card direct solve:
    init, edges = bench.multi_loop_graph(SOLVE_NODES)
    part = sd.make_segments(SOLVE_NODES, edges, max_seg_len=64)
    p1, c1 = sd.optimize_direct(init, edges, part, iterations=SOLVE_ITERS)
    p4, c4 = sparse_direct_sharded.optimize_direct_sharded(
        mesh, init, edges, part, iterations=SOLVE_ITERS
    )
    chk.le("direct_sharded_vs_1card_pose",
           np.max(np.abs(np.asarray(p4) - np.asarray(p1))), SOLVE_POSE_TOL)
    chk.le("direct_sharded_vs_1card_chi2_rel",
           abs(float(c4) - float(c1)) / max(abs(float(c1)), 1e-9),
           SOLVE_CHI2_RTOL)
    print(f"four-cards (solve): {chk.text()}", flush=True)

    # Fleet data parallelism: 4 cards x 8 streams vs 32 streams on one.
    fp = presets.fleet_serving()
    inputs = fleet_inputs(fp, 4 * FLEET_B, FLEET_T)
    run = jax.jit(
        lambda *a: scan_driver.run_sequence_batch.__wrapped__(fp, *a)[1]
    )

    def put(x, sharding):
        return jax.device_put(x, sharding)

    dp = NamedSharding(mesh, P("dp"))
    t0 = time.perf_counter()
    t_mesh = np.asarray(run(*jax.tree.map(lambda x: put(x, dp), inputs)))
    wall_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    t_one = np.asarray(run(*jax.tree.map(lambda x: put(x, one), inputs)))
    wall_one = time.perf_counter() - t0
    chk.le("fleet_dp4_vs_1card_pose_m", np.max(np.abs(t_mesh - t_one)),
           FLEET_POSE_TOL_M, f"{4 * FLEET_B} streams x {FLEET_T} scans")
    print(f"four-cards (fleet): first call (compile + run) 4 cards "
          f"{wall_mesh:.2f} s, 1 card {wall_one:.2f} s; {chk.text()}",
          flush=True)

    # Sharded link proposal vs the one-card batch on the same pairs.
    fuser_p, stacked, ref, mov, mask = link_nodes()
    key = jax.random.PRNGKey(3)
    ls1 = links_mod.compute_links_batch(
        fuser_p.features, fuser_p.ndt.resolution, stacked, ref, mov, mask,
        key,
    )
    ls4 = links_sharded.compute_links_sharded(
        mesh, fuser_p.features, fuser_p.ndt.resolution, stacked, ref, mov,
        mask, key,
    )
    m1 = np.asarray(ls1.mask)
    m4 = np.asarray(ls4.mask)
    chk.true("links_valid_mask_equal", (m1 == m4).all(),
             f"{int(m1.sum())} valid of {int(mask.sum())} pairs")
    both = m1 & m4
    chk.le("links_T_dev", np.max(np.abs(np.asarray(ls1.T) - np.asarray(ls4.T))
                                 [both], initial=0.0), 1e-3)
    chk.le("links_score_dev",
           np.max(np.abs(np.asarray(ls1.score) - np.asarray(ls4.score))
                  [both], initial=0.0), 1e-3)


# ---------------------------------------------------------------- driver


def run_phase(name, fn, clock, *args):
    chk = Check()
    c0 = clock.total
    t0 = time.perf_counter()
    err = None
    try:
        fn(chk, *args)
    except Exception:  # reported below; the run still fails
        err = traceback.format_exc()
    wall = time.perf_counter() - t0
    ok = err is None and chk.ok
    peak = jax.devices()[0].memory_stats() or {}
    peak_gb = peak.get("peak_bytes_in_use", 0) / 1e9
    print(
        f"phase {name}: {'ok' if ok else 'FAILED'} | wall {wall:.2f} s | "
        f"compile {clock.total - c0:.2f} s | peak {peak_gb:.2f} GB | "
        f"{chk.text()}",
        flush=True,
    )
    if err:
        print(f"phase {name} raised:\n{err}", file=sys.stderr, flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded phase, on a 4-card mesh",
    )
    a = ap.parse_args(argv)
    devs = require_gpu()

    from ndt_feature_graph_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    clock = CompileClock()
    if a.four_cards:
        phases = [("device", phase_device, devs),
                  ("four_cards", phase_four_cards, devs)]
    else:
        phases = [
            ("device", phase_device, devs),
            ("registration", phase_registration),
            ("online_slam", phase_online),
            ("fleet", phase_fleet),
            ("offline_solve", phase_solve),
        ]
    results = [run_phase(p[0], p[1], clock, *p[2:]) for p in phases]
    if not all(results):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
