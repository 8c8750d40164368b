"""SE(2) pose-graph optimizer: batched Gauss-Newton.

Batched replacement of the iSAM bridge (optimizeGraphUsingISAM,
ndt_offline_mapper.h:40-107: prior Information(100*I) on node 0 + one
Pose2d_Pose2d_Factor per link + batch_optimization).  Instead of
sparse-Cholesky-with-elimination-ordering (isam/cholmod), factors are
linearized *in batch* (vmapped analytic Jacobians), scattered into the
dense normal-equations matrix, and solved with a damped dense solve for
graphs up to a few hundred nodes; the segment-Schur direct solver
(graph/sparse_direct.py) takes over beyond that (GraphParams.solver).

Edge measurement convention: meas = pose of node j expressed in node
i's frame (relative pose), i.e. meas ≈ inv(T_i) ∘ T_j, matching
Pose2d_Pose2d_Factor semantics.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.core import se2


def spd_info_np(cov, eps: float = 1e-6):
    """Host-side information matrix from a (possibly f32-noisy)
    covariance: symmetrize in f64, floor the eigenvalues at `eps`,
    invert in the eigenbasis.  Guaranteed symmetric positive definite
    with eigenvalues <= 1/eps.

    np.linalg.inv of a device-produced f32 covariance is NOT safe: a
    wide-spectrum covariance reconstructed in f32 can carry a slightly
    negative smallest eigenvalue, and its inverse is then indefinite
    (measured info eigenvalues to -3.6e6 on the 570-node study —
    negative chi2 contributions that corrupt the Gauss-Newton step)."""
    import numpy as np

    c = np.asarray(cov, np.float64)
    c = 0.5 * (c + c.T)
    if not np.isfinite(c).all():
        # A degenerate registration (no overlapping cells -> garbage
        # Hessian) can produce a non-finite covariance; claim only the
        # floor information instead of crashing the solve.  Such links
        # should normally be cut by the validation gates
        # (links.valid_links drops non-finite links) — this is the
        # defensive backstop for direct callers.
        return (np.eye(c.shape[0]) * eps).astype(np.float32)
    w, v = np.linalg.eigh(c)
    w = np.maximum(w, eps)
    return ((v / w) @ v.T).astype(np.float32)


class EdgeList(NamedTuple):
    """Padded factor list."""

    i: jnp.ndarray       # (E,) int32 ref node
    j: jnp.ndarray       # (E,) int32 mov node
    meas: jnp.ndarray    # (E, 3) relative pose (j in i's frame)
    info: jnp.ndarray    # (E, 3, 3) information matrix
    mask: jnp.ndarray    # (E,) bool
    # Optional (E,) bool: True for odometry-chain factors (never a
    # wrong data association -> exempt from robust reweighting).  When
    # None, |i-j| == 1 is used as a fallback classifier — which
    # misclassifies a loop closure between ADJACENT nodes (reachable
    # with valid_min_idx_dist=1) as odometry; producers that know the
    # provenance (graph/slam.py) set this explicitly.
    is_odom: jnp.ndarray | None = None


def edge_is_loop(edges: EdgeList) -> jnp.ndarray:
    """(E,) bool: which factors are loop closures (robust-kernel
    candidates).  Prefers the explicit provenance flag."""
    if edges.is_odom is not None:
        return ~edges.is_odom
    return jnp.abs(edges.i - edges.j) != 1


def edge_residual(Ti, Tj, meas):
    """r = (inv(Ti) ∘ Tj) ⊖ meas with wrapped angle."""
    pred = se2.sub(Ti, Tj)
    r = pred - meas
    return r.at[..., 2].set(se2.normalize_angle(pred[..., 2] - meas[..., 2]))


def _edge_jacobians(Ti, Tj, meas):
    """Analytic Jacobians of edge_residual wrt Ti and Tj, each (3, 3)."""
    ci, si = jnp.cos(Ti[2]), jnp.sin(Ti[2])
    dx = Tj[0] - Ti[0]
    dy = Tj[1] - Ti[1]
    # pred = [ c*dx + s*dy, -s*dx + c*dy, tj - ti ]
    Ji = jnp.array(
        [
            [-ci, -si, -si * dx + ci * dy],
            [si, -ci, -ci * dx - si * dy],
            [0.0, 0.0, -1.0],
        ]
    )
    Jj = jnp.array(
        [
            [ci, si, 0.0],
            [-si, ci, 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    return Ji, Jj


def robust_edge_scale(r, edges: EdgeList, kernel: str, delta: float):
    """IRLS weights for loop-closure factors (robust M-estimation).

    The reference trusts every link that survives getValidLinks
    (ndt_feature_graph.cpp:527-556) — workable at its 8-node demo scale,
    chaotic at 500+ nodes where the gates are applied against drifted
    estimates and wrong-basin registrations slip through.  Here
    non-sequential (loop-closure) factors get a robust kernel; the
    odometry chain (|i-j| == 1) stays quadratic (it is never a wrong
    data association).

    kernel: "none" | "huber" (delta = Mahalanobis-norm threshold) |
    "dcs" (Dynamic Covariance Scaling, Agarwal et al. ICRA 2013;
    delta = Phi lower bound).  Returns (scale (E,), rho (E,)): per-edge
    information scale factors and the per-edge robust cost (for
    monotone step control a robust linearization must be judged by the
    robust cost).

    The DCS Phi is MEDIAN-ADAPTIVE: Phi_eff = max(delta,
    median loop-edge chi2).  A fixed small Phi crushes *correct*
    closures whenever the initial estimate is drifted (every loop
    residual is then large — the kernel cannot tell outliers from
    drift, and with few closures nothing pulls the graph back:
    measured on the drifty-odometry scenario, fixed Phi=1 left node
    ATE at 0.62 where the quadratic solve reaches 0.15).  Scaling Phi
    to the median keeps the *typical* closure near full weight while
    still suppressing the tail that disagrees with the consensus —
    and as the fixpoint iterations converge the median falls, so the
    kernel tightens automatically: graduated non-convexity without a
    schedule."""
    chi2_e = jnp.einsum("ei,eij,ej->e", r, edges.info, r)
    if kernel == "none":
        return jnp.ones_like(chi2_e), chi2_e
    is_loop = edge_is_loop(edges)
    act = is_loop & edges.mask
    # Masked median of loop-edge chi2 (inactive slots sort to +inf).
    vals = jnp.sort(jnp.where(act, chi2_e, jnp.inf))
    cnt = jnp.sum(act)
    med = vals[jnp.clip((cnt - 1) // 2, 0, chi2_e.shape[0] - 1)]
    med = jnp.where(cnt > 0, med, delta)
    delta_eff = jnp.maximum(delta, med)
    if kernel == "huber":
        d = jnp.sqrt(delta_eff)
        u = jnp.sqrt(jnp.maximum(chi2_e, 1e-12))
        w = jnp.minimum(1.0, d / u)
        rho = jnp.where(
            chi2_e <= delta_eff, chi2_e, 2.0 * d * u - delta_eff
        )
    elif kernel == "dcs":
        s = jnp.minimum(1.0, 2.0 * delta_eff / (delta_eff + chi2_e))
        w = s * s
        rho = s * s * chi2_e + 2.0 * delta_eff * (1.0 - s) ** 2
    else:
        raise ValueError(f"unknown robust kernel {kernel!r}")
    scale = jnp.where(is_loop, w, 1.0)
    rho = jnp.where(is_loop, rho, chi2_e)
    return scale, rho


def assemble_normal_equations(p, edges: EdgeList, n: int,
                              info_scale=None):
    """Batched factor linearization into dense block normal equations.

    Returns H (n, n, 3, 3) and b (n, 3).  This is the unit of work that
    shards over a device mesh: edge subsets produce *additive*
    contributions, so a psum over per-shard results reconstructs the
    global system exactly (parallel/solver_sharded.py).
    info_scale: optional (E,) per-edge information scaling (IRLS robust
    weights from robust_edge_scale).
    """
    Ti = p[edges.i]
    Tj = p[edges.j]
    r = edge_residual(Ti, Tj, edges.meas)
    Ji, Jj = jax.vmap(_edge_jacobians)(Ti, Tj, edges.meas)

    w = edges.mask[:, None, None].astype(p.dtype)
    info = edges.info * w
    if info_scale is not None:
        info = info * info_scale[:, None, None]
    Hii = jnp.einsum("eki,ekl,elj->eij", Ji, info, Ji)
    Hjj = jnp.einsum("eki,ekl,elj->eij", Jj, info, Jj)
    Hij = jnp.einsum("eki,ekl,elj->eij", Ji, info, Jj)
    bi = jnp.einsum("eki,ekl,el->ei", Ji, info, r)
    bj = jnp.einsum("eki,ekl,el->ei", Jj, info, r)

    H = jnp.zeros((n, n, 3, 3), p.dtype)
    H = H.at[edges.i, edges.i].add(Hii)
    H = H.at[edges.j, edges.j].add(Hjj)
    H = H.at[edges.i, edges.j].add(Hij)
    H = H.at[edges.j, edges.i].add(jnp.swapaxes(Hij, -1, -2))
    b = jnp.zeros((n, 3), p.dtype)
    b = b.at[edges.i].add(bi)
    b = b.at[edges.j].add(bj)
    return H, b


def f32_matmul(fn):
    """Correctness guard for the pose-graph LINEAR SOLVES: trace the
    wrapped solver under float32 matmul precision.

    At default precision an accelerator may run f32 dots with reduced
    mantissas (TF32 on the GPU: 10 bits); inside an LU/triangular
    solve on a damped normal matrix (condition ~1e10: information up
    to 1/link_info_eps over damping 1e-6) that destroys the
    factorization and silently corrupts the trajectory.  The solves
    are a small share of any pipeline, so full f32 costs little."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


@f32_matmul
@functools.partial(
    jax.jit, static_argnames=("iterations", "robust_kernel")
)
def optimize(
    poses,
    edges: EdgeList,
    prior_information: float = 100.0,
    iterations: int = 20,
    damping: float = 1e-6,
    robust_kernel: str = "none",
    robust_delta: float = 1.0,
):
    """Gauss-Newton over all node poses.

    poses: (N, 3).  Node 0 is softly pinned with `prior_information * I`
    at its initial value (the iSAM bridge's prior factor,
    ndt_offline_mapper.h:61).  Loop-closure factors optionally get a
    robust kernel (robust_edge_scale) via IRLS reweighting each
    iteration.  Returns (poses, final_chi2) — chi2 is the robust cost.
    """
    n = poses.shape[0]
    dim = 3 * n
    prior_pose = poses[0]

    def chi2(p):
        r = edge_residual(p[edges.i], p[edges.j], edges.meas)
        _, rho = robust_edge_scale(r, edges, robust_kernel, robust_delta)
        c = jnp.sum(jnp.where(edges.mask, rho, 0.0))
        rp = p[0] - prior_pose
        rp = rp.at[2].set(se2.normalize_angle(rp[2]))
        return c + prior_information * jnp.dot(rp, rp)

    def gn_step(p, _):
        if robust_kernel == "none":
            scale = None
        else:
            r = edge_residual(p[edges.i], p[edges.j], edges.meas)
            scale, _ = robust_edge_scale(
                r, edges, robust_kernel, robust_delta
            )
        H, b = assemble_normal_equations(p, edges, n, info_scale=scale)

        # Prior on node 0.
        rp = p[0] - prior_pose
        rp = rp.at[2].set(se2.normalize_angle(rp[2]))
        H = H.at[0, 0].add(prior_information * jnp.eye(3, dtype=p.dtype))
        b = b.at[0].add(prior_information * rp)

        Hd = H.transpose(0, 2, 1, 3).reshape(dim, dim)
        bd = b.reshape(dim)
        # Guard unconstrained (inactive) nodes with a unit diagonal
        # BEFORE damping (a previous version tested the damped
        # diagonal, where 1e-6 >= 1e-8 meant the guard never fired,
        # leaving 1e-6 pivots in the factorization).
        diag = jnp.diagonal(Hd)
        Hd = Hd + jnp.diag(jnp.where(diag < 1e-8, 1.0, 0.0))
        Hd = Hd + damping * jnp.eye(dim, dtype=p.dtype)

        delta = -jnp.linalg.solve(Hd, bd).reshape(n, 3)
        p_new = p + delta
        p_new = p_new.at[:, 2].set(se2.normalize_angle(p_new[:, 2]))
        return p_new, None

    poses_out, _ = jax.lax.scan(gn_step, poses, None, length=iterations)
    return poses_out, chi2(poses_out)
