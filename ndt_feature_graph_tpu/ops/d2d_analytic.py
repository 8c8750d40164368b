"""Analytic D2D derivatives: score + gradient + Hessian in ONE pass
over cell pairs.

This is the batched `derivativesNDT` (perception_oru's hand-derived
Magnusson-2009 derivatives, the hot loop of the reference's Newton
iteration — SURVEY.md §3.1).  The autodiff path (ops/d2d.py) evaluates
the cost ~4x per Newton trial (value + reverse pass + 3 forward-over-
reverse columns); this closed form computes all three quantities in a
single fused sweep.  ops/d2d.py's autodiff remains the verification
oracle: tests/test_d2d_analytic.py checks agreement to float tolerance.

Derivation (SE(2) left-increment p = (dx, dy, dtheta) at evaluation
point d, per pair with T0-pretransformed source gaussians (m, C) and
target (mu2, S2)):
    R = R(dtheta), R' = dR/dtheta
    mu  = R m + t - mu2,         Sig = R C R^T + S2,   A = Sig^{-1}
    q   = mu^T A mu,             s = -d1 exp(-(d2/2) q)
    J   = [e_x, e_y, R' m]                        (dmu/dp)
    S   = R' C R^T + R C R'^T                     (dSig/dtheta)
    A_t = -A S A                                  (dA/dtheta)
    q_i   = 2 mu^T A J_i + [i==theta] mu^T A_t mu
    q_ij  = 2 J_j^T A J_i
          + [j==t] 2 mu^T A_t J_i + [i==t] 2 mu^T A_t J_j
          + [i==j==t] (2 mu^T A mu_tt + 4 mu^T A_t mu_t + mu^T A_tt mu)
      with mu_tt = -R m,  S2d = -2 R C R^T + 2 R' C R'^T,
           A_tt = 2 A S A S A - A S2d A
    g_i  = d1 a e^{-aq} q_i,  H_ij = d1 a e^{-aq} (q_ij - a q_i q_j),
      a = d2/2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import MatcherParams, NDTMapParams
from ndt_feature_graph_tpu.ops.d2d import DenseTarget
from ndt_feature_graph_tpu.ops.ndt_map import CellList


def _pair_fgh_terms(mu, Sig, m_rot, Crot, lfd1, lfd2):
    """Per-pair score, gradient and upper Hessian as ten elementwise
    arrays (s, g0, g1, g2, h00, h01, h02, h11, h12, h22), batched over
    leading dims (broadcasting).

    mu: (..., 2) mean difference; Sig: (..., 2, 2) summed covariance;
    m_rot: the rotation-dependent part of the moved source mean at the
    evaluation point (moved_mean - d_translation — the left-increment's
    rotation acts on everything except d's own translation);
    Crot = rotated source cov K.  Derivatives use the rotation generator
    G = [[0,-1],[1,0]] applied to m_rot/Crot.

    The 2x2 algebra is unrolled into scalar lanes: no matmul, so the
    result is plain float32 at any matmul precision setting (TF32 would
    otherwise round einsum operands to 10 mantissa bits), and XLA fuses
    the whole chain with the masked sum that follows.
    """
    mu_x, mu_y = mu[..., 0], mu[..., 1]
    s00, s01, s11 = Sig[..., 0, 0], Sig[..., 0, 1], Sig[..., 1, 1]
    mx, my = m_rot[..., 0], m_rot[..., 1]
    c00, c01, c11 = Crot[..., 0, 0], Crot[..., 0, 1], Crot[..., 1, 1]

    # A = Sig^{-1}
    inv = 1.0 / jnp.maximum(s00 * s11 - s01 * s01, 1e-12)
    a00, a01, a11 = s11 * inv, -s01 * inv, s00 * inv
    amu_x = a00 * mu_x + a01 * mu_y
    amu_y = a01 * mu_x + a11 * mu_y
    q = mu_x * amu_x + mu_y * amu_y

    # mu_t = G m_rot = (-my, mx); mu_tt = -m_rot
    mt_x, mt_y = -my, mx
    # S = G K + K G^T;  S2d = d/dtheta S = -2K + 2 G K G^T
    S00, S01, S11 = -2.0 * c01, c00 - c11, 2.0 * c01
    S2d00, S2d01, S2d11 = 2.0 * (c11 - c00), -4.0 * c01, 2.0 * (c00 - c11)

    # A S A mu
    sa_x = S00 * amu_x + S01 * amu_y
    sa_y = S01 * amu_x + S11 * amu_y
    asa_x = a00 * sa_x + a01 * sa_y
    asa_y = a01 * sa_x + a11 * sa_y

    # q_i: translations 2 (A mu)_i; theta 2 (A mu).mu_t - mu.(A S A mu)
    q_x = 2.0 * amu_x
    q_y = 2.0 * amu_y
    q_t = 2.0 * (amu_x * mt_x + amu_y * mt_y) - (mu_x * asa_x + mu_y * asa_y)

    # Hessian of q.  Translations: 2 A.  x/theta & y/theta:
    # 2 e_i^T A mu_t + 2 e_i^T A_t mu with A_t mu = -A S A mu.
    amt_x = a00 * mt_x + a01 * mt_y
    amt_y = a01 * mt_x + a11 * mt_y
    h_xx, h_xy, h_yy = 2.0 * a00, 2.0 * a01, 2.0 * a11
    h_xt = 2.0 * (amt_x - asa_x)
    h_yt = 2.0 * (amt_y - asa_y)
    # theta/theta: 2 mu_t^T A mu_t + 2 mu^T A mu_tt + 4 mu^T A_t mu_t
    #   + mu^T A_tt mu,  A_tt mu = 2 A S A S A mu - A S2d A mu
    t1 = 2.0 * (mt_x * amt_x + mt_y * amt_y)
    t2 = -2.0 * (amu_x * mx + amu_y * my)
    t3 = -4.0 * (asa_x * mt_x + asa_y * mt_y)
    sasa_x = S00 * asa_x + S01 * asa_y
    sasa_y = S01 * asa_x + S11 * asa_y
    s2a_x = S2d00 * amu_x + S2d01 * amu_y
    s2a_y = S2d01 * amu_x + S2d11 * amu_y
    att_x = 2.0 * (a00 * sasa_x + a01 * sasa_y) - (a00 * s2a_x + a01 * s2a_y)
    att_y = 2.0 * (a01 * sasa_x + a11 * sasa_y) - (a01 * s2a_x + a11 * s2a_y)
    h_tt = t1 + t2 + t3 + mu_x * att_x + mu_y * att_y

    a = 0.5 * lfd2
    E = jnp.exp(-a * q)
    k = (lfd1 * a) * E
    return (
        -lfd1 * E,
        k * q_x, k * q_y, k * q_t,
        k * (h_xx - a * q_x * q_x),
        k * (h_xy - a * q_x * q_y),
        k * (h_xt - a * q_x * q_t),
        k * (h_yy - a * q_y * q_y),
        k * (h_yt - a * q_y * q_t),
        k * (h_tt - a * q_t * q_t),
    )


def _masked_fgh_sum(mu, Sig, m_rot, Crot, ok, m: MatcherParams, axes):
    """Per-pair (score, grad (3,), Hessian (3, 3)) summed over `axes`
    where `ok`.

    The one pair-derivative reduction every registration path shares;
    its device time appears under the "pair_fgh_reduce" scope in a
    profiler trace.  The ten terms are stacked on a new leading axis
    and summed in ONE reduction (one kernel on the GPU, where ten
    separate sums launched ten)."""
    axes = (axes,) if isinstance(axes, int) else axes
    with jax.named_scope("pair_fgh_reduce"):
        terms = jnp.stack(
            _pair_fgh_terms(mu, Sig, m_rot, Crot, m.lfd1, m.lfd2)
        )
        s, g0, g1, g2, h00, h01, h02, h11, h12, h22 = jnp.sum(
            terms * ok.astype(jnp.float32),
            axis=tuple(a % ok.ndim + 1 for a in axes),
        )
        g = jnp.stack([g0, g1, g2], -1)
        H = jnp.stack(
            [
                jnp.stack([h00, h01, h02], -1),
                jnp.stack([h01, h11, h12], -1),
                jnp.stack([h02, h12, h22], -1),
            ],
            -2,
        )
        return s, g, H


def _fgh_reduce(d, moved, t_means, t_covs, t_valid, m: MatcherParams):
    """Shared reduction: per-pair fgh over gathered windows, masked sum."""
    mu = moved.means[:, None, :] - t_means
    Sig = moved.covs[:, None, :, :] + t_covs
    m_rot = (moved.means - d[:2])[:, None, :]
    ok = t_valid & moved.mask[:, None]
    return _masked_fgh_sum(
        mu, Sig, m_rot, moved.covs[:, None, :, :], ok, m, (0, 1)
    )


def fgh_dense(
    d,
    T0,
    src: CellList,
    tgt: DenseTarget,
    map_params: NDTMapParams,
    m: MatcherParams,
):
    """Analytic (score, grad, Hessian) of the dense D2D cost — exactly
    ops.d2d.d2d_score_dense's value/derivatives in one pass."""
    from ndt_feature_graph_tpu.ops.d2d import _apply_increment, gather_windows

    T = _apply_increment(d, T0)
    moved = src.transform(T)
    n = m.n_neighbours

    rel = (moved.means - tgt.origin) / map_params.resolution
    ix0 = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy0 = jnp.floor(rel[..., 1]).astype(jnp.int32)
    t_means, t_covs, t_valid = gather_windows(tgt, iy0, ix0, n)
    return _fgh_reduce(d, moved, t_means, t_covs, t_valid, m)


def fgh_dense_flat(
    d,
    T0,
    src: CellList,
    packed_flat,
    origin,
    row_offset,
    h: int,
    w: int,
    resolution: float,
    m: MatcherParams,
):
    """fgh_dense against a target selected by `row_offset` out of a
    FLAT packed bank (N*H*W, 8) — the batched-pair form: under vmap the
    window gather indexes the shared bank directly instead of first
    materializing a per-pair (H*W, 8) target copy (see
    d2d.gather_windows_flat).  Numerically identical to fgh_dense on
    the corresponding DenseTarget."""
    from ndt_feature_graph_tpu.ops.d2d import (
        _apply_increment, gather_windows_flat,
    )

    T = _apply_increment(d, T0)
    moved = src.transform(T)
    n = m.n_neighbours

    rel = (moved.means - origin) / resolution
    ix0 = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy0 = jnp.floor(rel[..., 1]).astype(jnp.int32)
    t_means, t_covs, t_valid = gather_windows_flat(
        packed_flat, h, w, iy0, ix0, n, row_offset
    )
    return _fgh_reduce(d, moved, t_means, t_covs, t_valid, m)


def fgh_paired(d, T0, src: CellList, tgt: CellList, m: MatcherParams):
    """Analytic (score, grad, Hessian) of the correspondence-restricted
    cost (ops.d2d.d2d_score_paired)."""
    from ndt_feature_graph_tpu.ops.d2d import _apply_increment

    T = _apply_increment(d, T0)
    moved = src.transform(T)
    mu = moved.means - tgt.means
    Sig = moved.covs + tgt.covs
    return _masked_fgh_sum(
        mu, Sig, moved.means - d[:2], moved.covs, src.mask & tgt.mask, m,
        0,
    )


def fgh_mahalanobis(d, Q):
    """(d^T Q d, (Q+Q^T) d, Q+Q^T) — the soft-constraint terms
    (fusion.h:11-32)."""
    Qs = Q + Q.T
    return d @ Q @ d, Qs @ d, Qs


def fgh_dense_flat_batch(
    d_b,            # (B, 3) per-lane increments
    T0_b,           # (B, 3) per-lane initial transforms
    src_b,          # CellList batched (B, N, ...)
    packed_flat,    # (R, 8) shared flat packed bank
    origins,        # (B, 2) per-lane target origins
    row_offsets,    # (B,) int32 per-lane bank row offsets
    h: int,
    w: int,
    resolution: float,
    m: MatcherParams,
):
    """Batched fgh_dense_flat for B lanes with ONE unbatched gather.

    vmap(fgh_dense_flat) makes the window gather's indices carry a
    batch dim over a shared operand, which can lower to a per-lane
    broadcast of the WHOLE bank (a f32[128, 5.12M, 8] = 20 GB
    allocation at B=128).  Here the per-lane geometry runs under vmap (cheap
    elementwise math) but the gather is issued manually with FLATTENED
    1-D indices — a plain gather, no operand batching dims.

    Returns (f (B,), g (B, 3), H (B, 3, 3)).
    """
    from ndt_feature_graph_tpu.ops.d2d import _apply_increment

    n = m.n_neighbours
    win = 2 * n + 1
    k = win * win

    def geom(d, T0, src, origin):
        T = _apply_increment(d, T0)
        moved = src.transform(T)
        rel = (moved.means - origin) / resolution
        ix0 = jnp.floor(rel[..., 0]).astype(jnp.int32)
        iy0 = jnp.floor(rel[..., 1]).astype(jnp.int32)
        return moved, iy0, ix0

    moved, iy0, ix0 = jax.vmap(geom)(d_b, T0_b, src_b, origins)

    offs = jnp.arange(-n, n + 1)
    dy = jnp.repeat(offs, win)
    dx = jnp.tile(offs, win)
    iy = iy0[..., None] + dy            # (B, N, K)
    ix = ix0[..., None] + dx
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
    linear = (row_offsets[:, None, None] + flat).reshape(-1)
    rows = packed_flat[linear].reshape(flat.shape + (8,))  # (B,N,K,8)

    t_means = rows[..., 0:2]
    c00 = rows[..., 2]
    c01 = rows[..., 3]
    c11 = rows[..., 4]
    t_covs = jnp.stack(
        [
            jnp.stack([c00, c01], -1),
            jnp.stack([c01, c11], -1),
        ],
        -2,
    )
    t_valid = (rows[..., 5] > 0.5) & inb

    mu = moved.means[..., None, :] - t_means              # (B,N,K,2)
    Sig = moved.covs[..., None, :, :] + t_covs            # (B,N,K,2,2)
    m_rot = (moved.means - d_b[:, None, :2])[..., None, :]
    ok = t_valid & moved.mask[..., None]

    return _masked_fgh_sum(
        mu, Sig, m_rot, moved.covs[..., None, :, :], ok, m, (1, 2)
    )


def fgh_dense_window_batch(
    d_b,            # (B, 3)
    T0_b,           # (B, 3)
    src_b,          # CellList batched (B, N, ...)
    wide_flat,      # (R, (2n+1)*8) win-row table (d2d.build_window_tables)
    cell0,          # (B, 2) int32 window-corner cell coords (wx0, wy0)
    origins,        # (B, 2) GRID origins (world)
    wh: int,        # window height in cells
    ww: int,        # window width in cells
    resolution: float,
    m: MatcherParams,
    rel_means: bool = False,
    row_offsets=None,
):
    """fgh_dense_wide_batch against per-stream WINDOW win-row tables
    (d2d.build_window_tables): gather indices are window-relative
    (global cell minus `cell0`), rows outside the window are masked
    (identical to off-grid when the window covers the sensor disc —
    see config.gather_window_cells), and with rel_means=True the
    gathered (possibly bf16) cell-relative means are upcast to f32 and
    re-anchored at their cells' world centres before the pair math.

    Returns (f (B,), g (B, 3), H (B, 3, 3)).
    """
    from ndt_feature_graph_tpu.ops.d2d import _apply_increment

    n = m.n_neighbours
    win = 2 * n + 1
    wp = ww + 2 * n
    b = d_b.shape[0]
    if row_offsets is None:
        # Default: lane b owns table slab b (the fleet shape).  Pair
        # registration against a stacked NODE bank passes explicit
        # offsets (ref_index * stride) instead — many lanes may read
        # the same slab (graph/links.refine_links_d2d).
        row_offsets = jnp.arange(b, dtype=jnp.int32) * (wh * wp)

    def geom(d, T0, src, origin):
        T = _apply_increment(d, T0)
        moved = src.transform(T)
        rel = (moved.means - origin) / resolution
        ix0 = jnp.floor(rel[..., 0]).astype(jnp.int32)
        iy0 = jnp.floor(rel[..., 1]).astype(jnp.int32)
        return moved, iy0, ix0

    moved, iy0g, ix0g = jax.vmap(geom)(d_b, T0_b, src_b, origins)
    iy0 = iy0g - cell0[:, 1:2]                      # window-relative
    ix0 = ix0g - cell0[:, 0:1]

    offs = jnp.arange(-n, n + 1)
    iy = iy0[..., None] + offs                       # (B, N, win)
    inb_y = (iy >= 0) & (iy < wh)
    jx0 = ix0 + n                                    # padded column
    inb_x0 = (jx0 >= 0) & (jx0 < wp)                 # (B, N)
    flat = jnp.clip(iy, 0, wh - 1) * wp + jnp.clip(jx0, 0, wp - 1)[
        ..., None
    ]
    linear = (row_offsets[:, None, None] + flat).reshape(-1)
    rows = wide_flat[linear].reshape(
        flat.shape + (win * 8,)
    )                                                # (B, N, win, win*8)
    rows = rows.reshape(flat.shape + (win, 8))       # (B,N,dy,dx,8)
    k = win * win
    rows = rows.reshape(rows.shape[:2] + (k, 8))     # (B, N, K, 8)
    rows = rows.astype(jnp.float32)

    t_means = rows[..., 0:2]
    if rel_means:
        # Re-anchor cell-relative means: element k of a window sits at
        # global cell (iy0g + dy, ix0g + dx), dy = k // win - n,
        # dx = k % win - n.
        dxk = (jnp.arange(k) % win - n).astype(jnp.float32)
        dyk = (jnp.arange(k) // win - n).astype(jnp.float32)
        cxk = (
            origins[:, None, None, 0]
            + (ix0g[..., None].astype(jnp.float32) + dxk + 0.5)
            * resolution
        )
        cyk = (
            origins[:, None, None, 1]
            + (iy0g[..., None].astype(jnp.float32) + dyk + 0.5)
            * resolution
        )
        t_means = t_means + jnp.stack([cxk, cyk], -1)
    c00 = rows[..., 2]
    c01 = rows[..., 3]
    c11 = rows[..., 4]
    t_covs = jnp.stack(
        [
            jnp.stack([c00, c01], -1),
            jnp.stack([c01, c11], -1),
        ],
        -2,
    )
    inb = (
        jnp.repeat(inb_y, win, axis=-1)              # (B, N, K) dy-major
        & inb_x0[..., None]
    )
    t_valid = (rows[..., 5] > 0.5) & inb

    mu = moved.means[..., None, :] - t_means
    Sig = moved.covs[..., None, :, :] + t_covs
    m_rot = (moved.means - d_b[:, None, :2])[..., None, :]
    ok = t_valid & moved.mask[..., None]

    return _masked_fgh_sum(
        mu, Sig, m_rot, moved.covs[..., None, :, :], ok, m, (1, 2)
    )


def fgh_dense_block_batch(
    d_b,            # (B, 3)
    T0_b,           # (B, 3)
    src_b,          # CellList batched (B, N, ...)
    block_flat,     # (R, (2n+1)^2*8) win-block table
    cell0,          # (B, 2) int32 window-corner cell coords
    origins,        # (B, 2) grid origins (world)
    wc: int,        # window side in cells
    resolution: float,
    m: MatcherParams,
    rel_means: bool = False,
):
    """fgh against WIN-BLOCK window tables
    (d2d.build_window_block_tables): ONE gathered row per source cell
    carries its whole (2n+1)^2 neighbourhood — the minimum possible
    row count for the window association.  Masking: the
    doubly-padded table gives every centre whose window intersects the
    window slice an exact row with per-cell validity; centres outside
    the padded bounds have fully-off-window neighbourhoods and are
    masked here.  With rel_means=True the (bf16) cell-relative means
    are upcast and re-anchored in f32 after the gather.

    Returns (f (B,), g (B, 3), H (B, 3, 3)).
    """
    from ndt_feature_graph_tpu.ops.d2d import _apply_increment

    n = m.n_neighbours
    win = 2 * n + 1
    hp = wc + 2 * n
    k = win * win
    b = d_b.shape[0]
    row_offsets = jnp.arange(b, dtype=jnp.int32) * (hp * hp)

    def geom(d, T0, src, origin):
        T = _apply_increment(d, T0)
        moved = src.transform(T)
        rel = (moved.means - origin) / resolution
        ix0 = jnp.floor(rel[..., 0]).astype(jnp.int32)
        iy0 = jnp.floor(rel[..., 1]).astype(jnp.int32)
        return moved, iy0, ix0

    moved, iy0g, ix0g = jax.vmap(geom)(d_b, T0_b, src_b, origins)
    iyp = iy0g - cell0[:, 1:2] + n                  # padded coords
    jxp = ix0g - cell0[:, 0:1] + n
    inb = (iyp >= 0) & (iyp < hp) & (jxp >= 0) & (jxp < hp)  # (B, N)
    flat = jnp.clip(iyp, 0, hp - 1) * hp + jnp.clip(jxp, 0, hp - 1)
    linear = (row_offsets[:, None] + flat).reshape(-1)
    rows = block_flat[linear].reshape(
        flat.shape + (k, 8)
    ).astype(jnp.float32)                           # (B, N, K, 8)

    t_means = rows[..., 0:2]
    if rel_means:
        dxk = (jnp.arange(k) % win - n).astype(jnp.float32)
        dyk = (jnp.arange(k) // win - n).astype(jnp.float32)
        cxk = (
            origins[:, None, None, 0]
            + (ix0g[..., None].astype(jnp.float32) + dxk + 0.5)
            * resolution
        )
        cyk = (
            origins[:, None, None, 1]
            + (iy0g[..., None].astype(jnp.float32) + dyk + 0.5)
            * resolution
        )
        t_means = t_means + jnp.stack([cxk, cyk], -1)
    c00 = rows[..., 2]
    c01 = rows[..., 3]
    c11 = rows[..., 4]
    t_covs = jnp.stack(
        [
            jnp.stack([c00, c01], -1),
            jnp.stack([c01, c11], -1),
        ],
        -2,
    )
    t_valid = (rows[..., 5] > 0.5) & inb[..., None]

    mu = moved.means[..., None, :] - t_means
    Sig = moved.covs[..., None, :, :] + t_covs
    m_rot = (moved.means - d_b[:, None, :2])[..., None, :]
    ok = t_valid & moved.mask[..., None]

    return _masked_fgh_sum(
        mu, Sig, m_rot, moved.covs[..., None, :, :], ok, m, (1, 2)
    )


def fgh_dense_wide_batch(
    d_b,            # (B, 3)
    T0_b,           # (B, 3)
    src_b,          # CellList batched (B, N, ...)
    wide_flat,      # (R, (2n+1)*8) win-row table (d2d.build_wide_table)
    origins,        # (B, 2)
    h: int,
    w: int,
    resolution: float,
    m: MatcherParams,
    row_offsets=None,   # (B,) explicit table-slab offsets (units of
                        # wide_row_stride); None = lane b -> slab b
):
    """fgh_dense_flat_batch against the WIN-ROW table: each source
    cell's (2n+1)^2 window is (2n+1) gathered win-rows (vertical
    neighbours), each already carrying the (2n+1) horizontal cells —
    (2n+1)x fewer gather rows than the 8-channel table (see
    d2d.build_wide_table).  Numerically
    identical to fgh_dense_flat_batch everywhere including the
    horizontal edge bands: the table's padded column layout gives
    every centre column whose window intersects the grid an exact
    win-row with per-cell validity (tests/test_d2d_analytic.py::
    test_wide_batch_matches_flat_batch covers off-grid centres).

    Per-lane row offsets default to lane b -> slab b (stride =
    d2d.wide_row_stride(h, w, n) = h*(w+2n)); pair registration
    against a stacked node bank passes explicit offsets
    (ref_index * stride) so many lanes can read one slab.  This is
    the full-grid special case of fgh_dense_window_batch (cell0 = 0),
    to which it delegates.

    Returns (f (B,), g (B, 3), H (B, 3, 3)).
    """
    b = d_b.shape[0]
    cell0 = jnp.zeros((b, 2), jnp.int32)
    return fgh_dense_window_batch(
        d_b, T0_b, src_b, wide_flat, cell0, origins, h, w,
        resolution, m, rel_means=False, row_offsets=row_offsets,
    )
