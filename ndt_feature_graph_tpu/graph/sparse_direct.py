"""Sparse *direct* pose-graph solve: segment-Schur elimination.

The production large-graph path: the batched replacement for iSAM's sparse Cholesky (isam + cholmod, reference
ndt_offline_mapper.h:40-107) that — unlike graph/schur.py — never forms
the dense (N, N, 3, 3) normal equations.  It exploits the structure a
SLAM pose graph always has: a block-tridiagonal odometry chain plus a
sparse set of loop closures.

  separator S  = closure endpoints + node 0 + every max_seg_len-th node
  interiors    = the chain segments between consecutive separators

Interior systems are block-tridiagonal and independent, so each segment
factorizes with a block-Thomas recurrence — vmapped over segments, one
fixed-shape lax.scan of the padded segment length.  Splitting long runs
with artificial separators bounds the recurrence depth, which both
bounds f32 rounding growth (an unsegmented 4000-block Thomas recurrence
loses ALL accuracy in f32 — the chain inverse grows ~len^3 through the
theta-xy coupling) and raises parallelism.  Each segment couples to at
most its two bounding separators, so its Schur contribution is a pair
of 3x3-block outer products; the reduced separator system (3S x 3S,
S ~ #closures + N/max_seg_len) is dense — one dense device solve.

Exact: matches the dense solver to float tolerance
(tests/test_sparse_solver.py), O(N + S^2) memory, no iteration counts
to tune (direct, unlike graph/sparse.py's PCG which stalls on the low
modes of large loopy graphs).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.graph import optimize as opt

from ndt_feature_graph_tpu.graph.optimize import f32_matmul as _f32
from ndt_feature_graph_tpu.graph import sparse


class SegPartition(NamedTuple):
    """Host-precomputed static elimination structure."""

    sep_ids: jnp.ndarray    # (S,) int32 separator node ids (sorted)
    sep_of: jnp.ndarray     # (N,) int32 node -> separator index, -1 if interior
    idx: jnp.ndarray        # (B, L) int32 interior node ids per segment (padded)
    imask: jnp.ndarray      # (B, L) bool
    seg_len: jnp.ndarray    # (B,) int32
    seg_left: jnp.ndarray   # (B,) int32 separator index of node idx[b,0]-1
    seg_right: jnp.ndarray  # (B,) int32 separator index right of segment, -1 if none


def make_segments(n_nodes, edges: opt.EdgeList,
                  max_seg_len: int = 256) -> SegPartition:
    """Separator extraction + segment layout (host-side, cheap).

    Separators: endpoints of every non-sequential (loop-closure) edge,
    node 0 (prior anchor), and an artificial separator every
    max_seg_len nodes inside long runs.
    """
    ei = np.asarray(edges.i)
    ej = np.asarray(edges.j)
    em = np.asarray(edges.mask)
    nonchain = em & (np.abs(ei.astype(np.int64) - ej) != 1)
    sep = np.zeros(n_nodes, bool)
    sep[ei[nonchain]] = True
    sep[ej[nonchain]] = True
    sep[0] = True
    run = 0
    for k in range(n_nodes):
        if sep[k]:
            run = 0
        else:
            run += 1
            if run >= max_seg_len:
                sep[k] = True
                run = 0

    sep_ids = np.nonzero(sep)[0].astype(np.int32)
    sep_of = np.full(n_nodes, -1, np.int32)
    sep_of[sep_ids] = np.arange(len(sep_ids), dtype=np.int32)

    # Maximal runs of interior nodes.
    segs = []
    k = 0
    while k < n_nodes:
        if sep[k]:
            k += 1
            continue
        start = k
        while k < n_nodes and not sep[k]:
            k += 1
        segs.append((start, k - start))
    if not segs:
        segs = [(0, 0)]  # dummy empty segment keeps shapes non-degenerate

    B = len(segs)
    L = max(max(ln for _, ln in segs), 1)
    idx = np.zeros((B, L), np.int32)
    imask = np.zeros((B, L), bool)
    seg_len = np.zeros(B, np.int32)
    seg_left = np.zeros(B, np.int32)
    seg_right = np.full(B, -1, np.int32)
    for b, (start, ln) in enumerate(segs):
        cols = np.arange(L)
        idx[b] = np.clip(start + cols, 0, n_nodes - 1)
        imask[b, :ln] = True
        seg_len[b] = ln
        seg_left[b] = sep_of[start - 1] if (ln > 0 and start > 0) else -1
        end = start + ln
        seg_right[b] = sep_of[end] if (ln > 0 and end < n_nodes) else -1
    return SegPartition(
        sep_ids=jnp.asarray(sep_ids),
        sep_of=jnp.asarray(sep_of),
        idx=jnp.asarray(idx),
        imask=jnp.asarray(imask),
        seg_len=jnp.asarray(seg_len),
        seg_left=jnp.asarray(seg_left),
        seg_right=jnp.asarray(seg_right),
    )


def chain_coupling(Hij, edges: opt.EdgeList, n):
    """C[k] = H[k, k+1] accumulated from sequential edges.  Additive
    over edge shards."""
    dtype = Hij.dtype
    C = jnp.zeros((max(n - 1, 1), 3, 3), dtype)
    diff = edges.j - edges.i
    fwd = (diff == 1) & edges.mask
    bwd = (diff == -1) & edges.mask
    kf = jnp.clip(edges.i, 0, n - 2)
    kb = jnp.clip(edges.j, 0, n - 2)
    C = C.at[kf].add(jnp.where(fwd[:, None, None], Hij, 0.0))
    C = C.at[kb].add(
        jnp.where(bwd[:, None, None], jnp.swapaxes(Hij, -1, -2), 0.0)
    )
    return C


def sep_coupling(Hij, edges: opt.EdgeList, sep_of, S):
    """Off-diagonal H_SS contributions from edges whose endpoints are
    both separators.  Additive over edge shards; returns (S, S, 3, 3)
    with zero diagonal part (the diagonal comes from blocks.D)."""
    dtype = Hij.dtype
    si = sep_of[edges.i]
    sj = sep_of[edges.j]
    both = (si >= 0) & (sj >= 0) & edges.mask
    w = both[:, None, None].astype(dtype)
    H_SS = jnp.zeros((S, S, 3, 3), dtype)
    H_SS = H_SS.at[jnp.clip(si, 0), jnp.clip(sj, 0)].add(Hij * w)
    H_SS = H_SS.at[jnp.clip(sj, 0), jnp.clip(si, 0)].add(
        jnp.swapaxes(Hij, -1, -2) * w
    )
    return H_SS


def _thomas_solve(D, C, rhs):
    """Block-tridiagonal solve for one (padded) segment.

    D (L, 3, 3) diagonal blocks, C (L-1, 3, 3) super-diagonal
    (C[k] = A[k, k+1]), rhs (L, 3, R).  Masked trailing positions must
    carry D=I, C=0, rhs=0 (decoupled identity rows).
    """
    L = D.shape[0]
    dtype = D.dtype
    zero_c = jnp.zeros((1, 3, 3), dtype)
    C_prev = jnp.concatenate([zero_c, C], 0)[:L]   # C_prev[k] = C[k-1]

    def fwd_step(carry, inputs):
        dtinv_prev, y_prev = carry
        Dk, Ck_prev, rk = inputs
        G = Ck_prev.T @ dtinv_prev                  # (3, 3)
        dt = Dk - G @ Ck_prev
        dtinv = jnp.linalg.inv(dt)
        y = rk - G @ y_prev
        return (dtinv, y), (dtinv, y)

    init = (jnp.zeros((3, 3), dtype),
            jnp.zeros(rhs.shape[1:], dtype))
    _, (dtinv, y) = jax.lax.scan(fwd_step, init, (D, C_prev, rhs))

    C_next = jnp.concatenate([C, zero_c], 0)[:L]    # C_next[k] = C[k]

    def bwd_step(x_next, inputs):
        dtinv_k, yk, Ck = inputs
        x = dtinv_k @ (yk - Ck @ x_next)
        return x, x

    _, x = jax.lax.scan(
        bwd_step, jnp.zeros(rhs.shape[1:], dtype),
        (dtinv, y, C_next), reverse=True,
    )
    return x


def segment_eliminate(D_nodes, b_nodes, C_chain, idx, imask, seg_len,
                      seg_right, n):
    """Vmapped per-segment interior elimination (block-Thomas).

    Takes the globally-accumulated diagonal blocks / gradient and the
    chain coupling explicitly so the distributed path
    (parallel/sparse_direct_sharded.py) can call it on its segment
    shard.  Returns the per-segment Schur/rhs contributions and the
    (z, Y_L, Y_R) context back-substitution needs.
    """
    dtype = D_nodes.dtype
    eye = jnp.eye(3, dtype=dtype)

    def one_segment(idx, imask, seg_len, seg_right):
        L = idx.shape[0]
        has = seg_len > 0
        has_r = seg_right >= 0
        D = jnp.where(imask[:, None, None], D_nodes[idx], eye)
        # Intra-segment couplings: C_chain between consecutive members.
        cm = (jnp.arange(L - 1) < seg_len - 1)[:, None, None]
        Cseg = jnp.where(cm, C_chain[jnp.clip(idx[:-1], 0, n - 2)], 0.0)

        first = idx[0]
        last = idx[jnp.clip(seg_len - 1, 0, L - 1)]
        # e_L = H[sepL, first] ; e_R = H[last, sepR].
        e_L = jnp.where(has, C_chain[jnp.clip(first - 1, 0, n - 2)], 0.0)
        e_R = jnp.where(
            has & has_r, C_chain[jnp.clip(last, 0, n - 2)], 0.0
        )

        rhs = jnp.zeros((L, 3, 7), dtype)
        rhs = rhs.at[:, :, 0].set(
            jnp.where(imask[:, None], b_nodes[idx], 0.0)
        )
        rhs = rhs.at[0, :, 1:4].set(e_L.T)
        onehot_last = (jnp.arange(L) == seg_len - 1).astype(dtype)
        rhs = rhs.at[:, :, 4:7].add(
            onehot_last[:, None, None] * e_R[None]
        )

        X = _thomas_solve(D, Cseg, rhs)            # (L, 3, 7)
        z = X[:, :, 0]
        Y_L = X[:, :, 1:4]
        Y_R = X[:, :, 4:7]
        Y_L_last = jnp.einsum("l,lij->ij", onehot_last, Y_L)
        Y_R_last = jnp.einsum("l,lij->ij", onehot_last, Y_R)
        z_last = jnp.einsum("l,li->i", onehot_last, z)

        dS_LL = e_L @ Y_L[0]
        dS_LR = e_L @ Y_R[0]
        dS_RL = e_R.T @ Y_L_last
        dS_RR = e_R.T @ Y_R_last
        dr_L = e_L @ z[0]
        dr_R = e_R.T @ z_last
        return (dS_LL, dS_LR, dS_RL, dS_RR, dr_L, dr_R,
                z, Y_L, Y_R)

    return jax.vmap(one_segment)(idx, imask, seg_len, seg_right)


def scatter_segment_contribs(H_SS, b_S, contribs, seg_left, seg_right):
    """Subtract the per-segment Schur/rhs contributions into the
    reduced system (additive over segment shards)."""
    dS_LL, dS_LR, dS_RL, dS_RR, dr_L, dr_R = contribs
    li = jnp.clip(seg_left, 0)
    ri = jnp.clip(seg_right, 0)
    H_SS = H_SS.at[li, li].add(-dS_LL)
    H_SS = H_SS.at[li, ri].add(-dS_LR)
    H_SS = H_SS.at[ri, li].add(-dS_RL)
    H_SS = H_SS.at[ri, ri].add(-dS_RR)
    b_S = b_S.at[li].add(-dr_L)
    b_S = b_S.at[ri].add(-dr_R)
    return H_SS, b_S


def reduced_solve(H_SS, b_S):
    """Dense reduced solve of the separator system."""
    S = b_S.shape[0]
    Sd = H_SS.transpose(0, 2, 1, 3).reshape(3 * S, 3 * S)
    diag = jnp.diagonal(Sd)
    Sd = Sd + jnp.diag(jnp.where(diag < 1e-8, 1.0, 0.0))
    return jnp.linalg.solve(Sd, b_S.reshape(-1)).reshape(S, 3)


def segment_backsub(z, Y_L, Y_R, xS, seg_left, seg_right):
    """x_I = z - Y_L xS_L - Y_R xS_R per segment (additive scatter by
    the caller)."""
    xS_L = xS[jnp.clip(seg_left, 0)]               # (B, 3)
    xS_R = jnp.where(
        (seg_right >= 0)[:, None], xS[jnp.clip(seg_right, 0)], 0.0
    )
    return (z
            - jnp.einsum("blij,bj->bli", Y_L, xS_L)
            - jnp.einsum("blij,bj->bli", Y_R, xS_R))


@_f32
def solve_normal_equations(blocks: sparse.EdgeBlocks,
                           edges: opt.EdgeList,
                           part: SegPartition, n):
    """Solve H x = b (blocks carry H sparsely, b = blocks.b) exactly."""
    dtype = blocks.D.dtype
    S = part.sep_ids.shape[0]
    C_chain = chain_coupling(blocks.Hij, edges, n)

    # ---- Reduced system assembly: separator-separator coupling.
    H_SS = sep_coupling(blocks.Hij, edges, part.sep_of, S)
    H_SS = H_SS.at[jnp.arange(S), jnp.arange(S)].add(
        blocks.D[part.sep_ids]
    )
    b_S = blocks.b[part.sep_ids]

    # ---- Per-segment interior elimination (vmapped block-Thomas).
    *contribs, z, Y_L, Y_R = segment_eliminate(
        blocks.D, blocks.b, C_chain, part.idx, part.imask,
        part.seg_len, part.seg_right, n,
    )
    H_SS, b_S = scatter_segment_contribs(
        H_SS, b_S, contribs, part.seg_left, part.seg_right
    )

    xS = reduced_solve(H_SS, b_S)

    # ---- Back-substitution per segment.
    x_I = segment_backsub(z, Y_L, Y_R, xS, part.seg_left,
                          part.seg_right)
    x = jnp.zeros((n, 3), dtype)
    x = x.at[part.sep_ids].set(xS)
    x = x.at[part.idx.reshape(-1)].add(
        jnp.where(part.imask.reshape(-1, 1), x_I.reshape(-1, 3), 0.0)
    )
    return x


@_f32
@functools.partial(
    jax.jit, static_argnames=("iterations", "robust_kernel")
)
def optimize_direct(
    poses,
    edges: opt.EdgeList,
    part: SegPartition,
    prior_information: float = 100.0,
    iterations: int = 20,
    damping: float = 1e-6,
    robust_kernel: str = "none",
    robust_delta: float = 1.0,
):
    """Gauss-Newton with the exact segment-Schur solve.

    Same contract as graph.optimize.optimize: returns (poses, chi2).
    Positions carry a compensated (double-single) correction term so
    edge residuals keep full relative accuracy on large maps, where
    plain f32 global coordinates flatten the chi2 landscape metres
    above the optimum (SURVEY.md §7 "numerical parity for ATE").
    Steps are Levenberg-Marquardt damped with accept/reject (the
    matchFusion step-control idea, fusion.h:1000-1031, applied to the
    graph solve): exact Newton steps on a 4k-node graph overshoot the
    linearization and then random-walk in the near-null gauge mode, so
    monotone chi2 is enforced.
    """
    n = poses.shape[0]
    prior_pose = poses[0]

    def chi2(p, p_lo):
        r = sparse.edge_residual_hl(p, p_lo, edges)
        _, rho = opt.robust_edge_scale(
            r, edges, robust_kernel, robust_delta
        )
        c = jnp.sum(jnp.where(edges.mask, rho, 0.0))
        rp = p[0] - prior_pose
        rp = rp.at[2].set(se2.normalize_angle(rp[2]))
        return c + prior_information * jnp.dot(rp, rp)

    def lm_step(carry, _):
        p, p_lo, lam, chi_prev = carry
        blocks = sparse.linearize_edges(
            p, edges, prior_information, lam, prior_pose,
            p_lo=p_lo, robust_kernel=robust_kernel,
            robust_delta=robust_delta,
        )
        delta = -solve_normal_equations(blocks, edges, part, n)
        xy, xy_lo = sparse.two_sum_update(
            p[:, :2], p_lo, delta[:, :2]
        )
        th = se2.normalize_angle(p[:, 2] + delta[:, 2])
        trial = jnp.concatenate([xy, th[:, None]], -1)
        chi_t = chi2(trial, xy_lo)
        accept = chi_t <= chi_prev
        p1 = jnp.where(accept, trial, p)
        lo1 = jnp.where(accept, xy_lo, p_lo)
        lam1 = jnp.where(
            accept,
            jnp.maximum(lam * 0.3, damping),
            jnp.minimum(lam * 8.0, 1e4),
        )
        chi1 = jnp.where(accept, chi_t, chi_prev)
        return (p1, lo1, lam1, chi1), None

    lo0 = jnp.zeros((n, 2), poses.dtype)
    carry0 = (poses, lo0, jnp.asarray(1e-2, poses.dtype),
              chi2(poses, lo0))
    (poses_out, _, _, chi_out), _ = jax.lax.scan(
        lm_step, carry0, None, length=iterations
    )
    return poses_out, chi_out
