"""Matrix-free sparse pose-graph solve: Gauss-Newton + block-Jacobi PCG.

The scale-up path past both the dense Cholesky (graph/optimize.py) and
the blocked Schur elimination (graph/schur.py): neither the (N, N, 3, 3)
normal-equations tensor nor any per-block dense matrix is ever formed.
Each Gauss-Newton step keeps only the per-edge Hessian blocks
(Hii, Hjj, Hij — O(E) memory) and solves the normal equations with
preconditioned conjugate gradients whose mat-vec is a batched
gather/scatter over the edge list.  This is the batched analogue of
what iSAM's sparse Cholesky (isam + cholmod, reference
ndt_offline_mapper.h:40-107, linked at ndt_feature/CMakeLists.txt:232)
buys the reference: memory and work proportional to the number of
factors, not nodes squared.

Why PCG instead of sparse Cholesky: elimination orderings are
pointer-chasing and data-dependent — hostile to XLA — while the CG
mat-vec is two gathers, three batched 3x3 matmuls, and two scatter-adds,
all fixed-shape.  A block-Jacobi preconditioner (per-node 3x3 diagonal
block inverse, vmapped closed-form solve) keeps iteration counts low on
pose graphs, whose conditioning is dominated by the odometry chain.

Exactness: converges to the dense solution (tests/test_sparse_solver.py
checks poses match graph.optimize.optimize to float tolerance), and
scales to graphs where the dense H would not fit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.graph import optimize as opt

from ndt_feature_graph_tpu.graph.optimize import f32_matmul as _f32


class EdgeBlocks(NamedTuple):
    """Per-edge linearized factor blocks (the sparse Hessian)."""

    Hii: jnp.ndarray    # (E, 3, 3)
    Hjj: jnp.ndarray    # (E, 3, 3)
    Hij: jnp.ndarray    # (E, 3, 3)
    b: jnp.ndarray      # (N, 3) gradient
    D: jnp.ndarray      # (N, 3, 3) diagonal blocks incl. prior + damping
    Dinv: jnp.ndarray   # (N, 3, 3) preconditioner
    D_base: jnp.ndarray  # (N, 3, 3) prior + damping (+ inactive guard)


def two_sum_update(hi, lo, b):
    """Compensated (double-single) update: (hi, lo) + b with the f32
    rounding error of the add recaptured in lo (Knuth two-sum +
    renormalize).  JAX/XLA does not reassociate floats, so the error
    term survives compilation."""
    s = hi + b
    bb = s - hi
    err = (hi - (s - bb)) + (b - bb)
    lo2 = lo + err
    hi2 = s + lo2
    lo3 = lo2 - (hi2 - s)
    return hi2, lo3


def edge_residual_hl(p, p_lo, edges: opt.EdgeList):
    """Edge residual with compensated xy differences.

    On long trajectories the cancellation tj - ti (global positions
    ~hundreds of units differing by ~1) destroys the low-mode signal in
    f32: the chi2 landscape goes flat at the rounding floor and the
    optimizer cannot see metres of smooth bending error (the reference
    never hits this because it is double-precision Eigen throughout).
    Carrying an f32 correction term for positions restores the
    difference to full f32 relative accuracy at *local* scale.
    """
    dxy = ((p[edges.j, :2] - p[edges.i, :2])
           + (p_lo[edges.j] - p_lo[edges.i]))
    th_i = p[edges.i, 2]
    c, s = jnp.cos(th_i), jnp.sin(th_i)
    local = jnp.stack(
        [c * dxy[:, 0] + s * dxy[:, 1],
         -s * dxy[:, 0] + c * dxy[:, 1]], -1
    )
    dth = se2.normalize_angle(
        p[edges.j, 2] - th_i - edges.meas[:, 2]
    )
    return jnp.concatenate([local - edges.meas[:, :2],
                            dth[:, None]], -1)


def linearize_edges_raw(p, edges: opt.EdgeList, n, p_lo=None,
                        info_scale=None):
    """Per-edge factor linearization, no prior/damping: returns
    (Hii, Hjj, Hij, D_edges, b_edges) where D_edges/b_edges are the
    node-scattered diagonal/gradient contributions of *these* edges.
    Additive over edge shards — the unit of work the distributed path
    psums (parallel/sparse_direct_sharded.py).  info_scale: optional
    (E,) IRLS robust weights (opt.robust_edge_scale)."""
    Ti = p[edges.i]
    Tj = p[edges.j]
    if p_lo is None:
        r = opt.edge_residual(Ti, Tj, edges.meas)
    else:
        r = edge_residual_hl(p, p_lo, edges)
    Ji, Jj = jax.vmap(opt._edge_jacobians)(Ti, Tj, edges.meas)

    w = edges.mask[:, None, None].astype(p.dtype)
    info = edges.info * w
    if info_scale is not None:
        info = info * info_scale[:, None, None]
    Hii = jnp.einsum("eki,ekl,elj->eij", Ji, info, Ji)
    Hjj = jnp.einsum("eki,ekl,elj->eij", Jj, info, Jj)
    Hij = jnp.einsum("eki,ekl,elj->eij", Ji, info, Jj)
    bi = jnp.einsum("eki,ekl,el->ei", Ji, info, r)
    bj = jnp.einsum("eki,ekl,el->ei", Jj, info, r)

    b = jnp.zeros((n, 3), p.dtype)
    b = b.at[edges.i].add(bi)
    b = b.at[edges.j].add(bj)
    D = jnp.zeros((n, 3, 3), p.dtype)
    D = D.at[edges.i].add(Hii)
    D = D.at[edges.j].add(Hjj)
    return Hii, Hjj, Hij, D, b


def finalize_blocks(p, D, b, Hii, Hjj, Hij, prior_information, damping,
                    prior_pose) -> EdgeBlocks:
    """Add the node-0 prior (Information = prior_information * I,
    ndt_offline_mapper.h:61), damping, and the inactive-node guard to
    globally-accumulated (D, b)."""
    n = p.shape[0]
    rp = p[0] - prior_pose
    rp = rp.at[2].set(se2.normalize_angle(rp[2]))
    D = D.at[0].add(prior_information * jnp.eye(3, dtype=p.dtype))
    b = b.at[0].add(prior_information * rp)

    eye = jnp.eye(3, dtype=p.dtype)
    # Unconstrained (padded / inactive) nodes get a unit block so the
    # system stays SPD and their update is exactly zero (b there is 0).
    deg = jnp.einsum("nii->n", D)
    inactive = (deg < 1e-8)[:, None, None]
    D_base = jnp.zeros((n, 3, 3), p.dtype)
    D_base = D_base.at[0].add(prior_information * eye)
    D_base = jnp.where(inactive, eye, D_base + damping * eye)
    D = jnp.where(inactive, eye, D + damping * eye)
    Dinv = jnp.linalg.inv(D)
    return EdgeBlocks(Hii=Hii, Hjj=Hjj, Hij=Hij, b=b, D=D, Dinv=Dinv,
                      D_base=D_base)


def linearize_edges(p, edges: opt.EdgeList, prior_information, damping,
                    prior_pose, p_lo=None, robust_kernel="none",
                    robust_delta=1.0):
    """Batched factor linearization kept in edge-block (sparse) form.

    Same math as graph.optimize.assemble_normal_equations (reference
    parity: batch linearization of Pose2d_Pose2d_Factor,
    ndt_offline_mapper.h:74-93) but never scatters into a dense H.
    Pass p_lo ((N, 2) compensated position corrections) on large maps —
    see edge_residual_hl.  robust_kernel applies IRLS loop-closure
    reweighting (opt.robust_edge_scale).
    """
    n = p.shape[0]
    if robust_kernel == "none":
        scale = None
    else:
        if p_lo is None:
            r = opt.edge_residual(p[edges.i], p[edges.j], edges.meas)
        else:
            r = edge_residual_hl(p, p_lo, edges)
        scale, _ = opt.robust_edge_scale(
            r, edges, robust_kernel, robust_delta
        )
    Hii, Hjj, Hij, D, b = linearize_edges_raw(p, edges, n, p_lo=p_lo,
                                              info_scale=scale)
    return finalize_blocks(p, D, b, Hii, Hjj, Hij, prior_information,
                           damping, prior_pose)


def hvp(blocks: EdgeBlocks, edges: opt.EdgeList, v):
    """H @ v without materializing H.

    Off-diagonal coupling comes from the per-edge blocks; the diagonal
    (incl. prior + damping + inactive-node guard) from blocks.D, with
    the per-edge diagonal contributions (already inside D) removed so
    nothing is double counted.
    """
    vi = v[edges.i]
    vj = v[edges.j]
    out = jnp.einsum("nij,nj->ni", blocks.D, v)
    # D already contains sum(Hii)+sum(Hjj); only cross terms remain.
    out = out.at[edges.i].add(jnp.einsum("eij,ej->ei", blocks.Hij, vj))
    out = out.at[edges.j].add(
        jnp.einsum("eji,ej->ei", blocks.Hij, vi)
    )
    return out


class ChainPrec(NamedTuple):
    """Block-Cholesky (Thomas) factorization of the block-tridiagonal
    part of H: diagonal blocks D plus the couplings of *sequential*
    edges (|i-j| == 1) — the odometry chain that carries most of a pose
    graph's stiffness.  PCG preconditioned with its exact solve only
    has to correct for loop closures, so iteration counts track the
    number of closures, not the graph diameter."""

    dtilde_inv: jnp.ndarray  # (N, 3, 3) inverses of eliminated diags
    C: jnp.ndarray           # (N-1, 3, 3) super-diagonal H[k, k+1]


def chain_preconditioner(blocks: EdgeBlocks, edges: opt.EdgeList,
                         n) -> ChainPrec:
    dtype = blocks.D.dtype
    C = jnp.zeros((max(n - 1, 1), 3, 3), dtype)
    diff = edges.j - edges.i
    fwd = (diff == 1) & edges.mask          # i=k,   j=k+1 -> H[k,k+1]
    bwd = (diff == -1) & edges.mask         # i=k+1, j=k   -> H[k,k+1]^T...
    kf = jnp.clip(edges.i, 0, n - 2)
    kb = jnp.clip(edges.j, 0, n - 2)
    C = C.at[kf].add(
        jnp.where(fwd[:, None, None], blocks.Hij, 0.0)
    )
    C = C.at[kb].add(
        jnp.where(bwd[:, None, None],
                  jnp.swapaxes(blocks.Hij, -1, -2), 0.0)
    )

    # Diagonal of the *chain-only* subgraph Hessian.  Including the
    # loop-closure diagonal contributions (blocks.D) would pin closure
    # endpoints to ground — M's low modes would not match H's and PCG
    # convergence collapses (preconditioned min-eig drops ~40x in
    # experiments).  M must be exactly H restricted to sequential edges
    # (+ prior + damping), so M^-1 H = I + low-rank closure correction.
    chain = fwd | bwd
    w = chain[:, None, None].astype(dtype)
    D_c = jnp.zeros((n, 3, 3), dtype)
    D_c = D_c.at[edges.i].add(blocks.Hii * w)
    D_c = D_c.at[edges.j].add(blocks.Hjj * w)
    deg = jnp.einsum("nii->n", D_c)
    D_c = D_c + blocks.D_base
    # Nodes untouched by chain edges (closure-only or isolated) fall
    # back to their full diagonal block: standalone in M, keeps M PD
    # without affecting the chain modes M must reproduce exactly.
    D_c = jnp.where((deg < 1e-8)[:, None, None], blocks.D, D_c)

    # Forward block elimination: d~_k = D_k - C_{k-1}^T d~_{k-1}^-1 C_{k-1}.
    def elim(prev_inv, inputs):
        Dk, Ck_prev = inputs
        dt = Dk - Ck_prev.T @ prev_inv @ Ck_prev
        dt_inv = jnp.linalg.inv(dt)
        return dt_inv, dt_inv

    zero_c = jnp.zeros((3, 3), dtype)
    Cs = jnp.concatenate([zero_c[None], C[: n - 1]], 0)[:n]
    _, dtilde_inv = jax.lax.scan(
        elim, jnp.zeros((3, 3), dtype), (D_c, Cs)
    )
    return ChainPrec(dtilde_inv=dtilde_inv, C=C)


def apply_chain_prec(prec: ChainPrec, r):
    """Solve M z = r with the Thomas factorization (two O(N) scans)."""
    n = r.shape[0]
    C_in = jnp.concatenate(
        [jnp.zeros((1, 3, 3), r.dtype), prec.C[: n - 1]], 0
    )[:n]

    def fwd(y_prev, inputs):
        rk, Ck_prev, dt_inv_prev = inputs
        y = rk - Ck_prev.T @ (dt_inv_prev @ y_prev)
        return y, y

    dt_inv_shift = jnp.concatenate(
        [jnp.eye(3, dtype=r.dtype)[None], prec.dtilde_inv[: n - 1]], 0
    )[:n]
    _, y = jax.lax.scan(
        fwd, jnp.zeros(3, r.dtype), (r, C_in, dt_inv_shift)
    )

    C_out = jnp.concatenate(
        [prec.C[: n - 1], jnp.zeros((1, 3, 3), r.dtype)], 0
    )[:n]

    def bwd(x_next, inputs):
        yk, dt_inv, Ck = inputs
        x = dt_inv @ (yk - Ck @ x_next)
        return x, x

    _, x_rev = jax.lax.scan(
        bwd, jnp.zeros(3, r.dtype),
        (y, prec.dtilde_inv, C_out), reverse=True,
    )
    return x_rev


def pcg(blocks: EdgeBlocks, edges: opt.EdgeList, rhs, cg_iterations,
        prec_apply=None, tol=1e-10):
    """PCG for H x = rhs; fixed-trip masked lax.scan (no data-dependent
    while_loop, see ops/d2d.newton_match).  prec_apply maps a
    residual to the preconditioned residual; defaults to block-Jacobi."""
    if prec_apply is None:
        def prec_apply(r):
            return jnp.einsum("nij,nj->ni", blocks.Dinv, r)

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = prec_apply(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)
    rhs_norm = jnp.vdot(rhs, rhs)

    def step(carry, _):
        x, r, p, rz, active = carry
        Hp = hvp(blocks, edges, p)
        pHp = jnp.vdot(p, Hp)
        alpha = rz / jnp.where(pHp == 0.0, 1.0, pHp)
        x1 = x + alpha * p
        r1 = r - alpha * Hp
        z1 = prec_apply(r1)
        rz1 = jnp.vdot(r1, z1)
        beta = rz1 / jnp.where(rz == 0.0, 1.0, rz)
        p1 = z1 + beta * p
        done = jnp.vdot(r1, r1) <= tol * tol * rhs_norm
        active1 = active & ~done
        x = jnp.where(active, x1, x)
        r = jnp.where(active, r1, r)
        p = jnp.where(active, p1, p)
        rz = jnp.where(active, rz1, rz)
        return (x, r, p, rz, active1), None

    (x, _, _, _, _), _ = jax.lax.scan(
        step, (x0, r0, p0, rz0, jnp.asarray(True)), None,
        length=cg_iterations,
    )
    return x


@_f32
@functools.partial(
    jax.jit,
    static_argnames=("iterations", "cg_iterations", "preconditioner",
                     "robust_kernel"),
)
def optimize_pcg(
    poses,
    edges: opt.EdgeList,
    prior_information: float = 100.0,
    iterations: int = 20,
    cg_iterations: int = 100,
    damping: float = 1e-6,
    preconditioner: str = "chain",
    robust_kernel: str = "none",
    robust_delta: float = 1.0,
):
    """Gauss-Newton with matrix-free PCG inner solve.

    Same contract as graph.optimize.optimize: returns (poses, chi2).
    O(E + N) memory per step — the production path for graphs beyond
    the dense solver's few-thousand-node range (ROADMAP item 2).

    preconditioner: "chain" (exact Thomas solve of the odometry-chain
    tridiagonal — CG iterations track loop-closure count, the right
    default for SLAM graphs) or "jacobi" (per-node 3x3 blocks — cheaper
    per iteration, slower information propagation).
    """
    prior_pose = poses[0]
    n = poses.shape[0]

    def chi2(p):
        r = opt.edge_residual(p[edges.i], p[edges.j], edges.meas)
        _, rho = opt.robust_edge_scale(
            r, edges, robust_kernel, robust_delta
        )
        c = jnp.sum(jnp.where(edges.mask, rho, 0.0))
        rp = p[0] - prior_pose
        rp = rp.at[2].set(se2.normalize_angle(rp[2]))
        return c + prior_information * jnp.dot(rp, rp)

    def gn_step(p, _):
        blocks = linearize_edges(
            p, edges, prior_information, damping, prior_pose,
            robust_kernel=robust_kernel, robust_delta=robust_delta,
        )
        if preconditioner == "chain":
            prec = chain_preconditioner(blocks, edges, n)

            def prec_apply(r):
                return apply_chain_prec(prec, r)
        else:
            prec_apply = None
        delta = -pcg(blocks, edges, blocks.b, cg_iterations,
                     prec_apply=prec_apply)
        p_new = p + delta
        p_new = p_new.at[:, 2].set(se2.normalize_angle(p_new[:, 2]))
        return p_new, None

    poses_out, _ = jax.lax.scan(gn_step, poses, None, length=iterations)
    return poses_out, chi2(poses_out)
