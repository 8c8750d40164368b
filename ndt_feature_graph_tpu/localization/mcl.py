"""NDT Monte-Carlo localization: batched particle filter on an NDT map.

Batched replacement of perception_oru's NDTMCL3D (wrapped by
ndt_feature_mcl_node.cpp:58-482), specialized to SE(2).  Particle
scoring — the reference's per-particle loop — is one (P, B) gather +
gaussian-likelihood batch, the embarrassingly-parallel workload SURVEY
§2.3 calls out as ideal for an accelerator.  Predict / weight / resample are
all jitted; systematic resampling uses a sorted-uniform inverse-CDF
lookup (searchsorted) instead of a sequential walk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ndt_feature_graph_tpu.config import MotionParams, NDTMapParams
from ndt_feature_graph_tpu.core import motion_model, se2
from ndt_feature_graph_tpu.ops import d2d


class ParticleSet(NamedTuple):
    poses: jnp.ndarray    # (P, 3)
    logw: jnp.ndarray     # (P,)

    @property
    def num(self):
        return self.poses.shape[0]


def init_uniform(key, n, center, spread_xy=1.0, spread_theta=0.3):
    k1, k2 = jax.random.split(key)
    xy = center[:2] + spread_xy * jax.random.uniform(
        k1, (n, 2), minval=-1.0, maxval=1.0
    )
    th = center[2] + spread_theta * jax.random.uniform(
        k2, (n, 1), minval=-1.0, maxval=1.0
    )
    return ParticleSet(
        poses=jnp.concatenate([xy, th], -1),
        logw=jnp.zeros(n),
    )


@functools.partial(jax.jit, static_argnames=("mp",))
def predict(key, particles: ParticleSet, Tmotion, mp: MotionParams):
    """Sample the motion model: compose each particle with Tmotion +
    noise drawn from the Eliazar covariance."""
    cov = motion_model.measurement_cov(mp, jnp.asarray(Tmotion))
    std = jnp.sqrt(jnp.diagonal(cov) + 1e-8)
    noise = jax.random.normal(key, particles.poses.shape) * std
    moved = se2.compose(particles.poses, Tmotion + noise)
    return particles._replace(poses=moved)


@functools.partial(jax.jit, static_argnames=("map_params",))
def weight(
    particles: ParticleSet,
    tgt: d2d.DenseTarget,
    map_params: NDTMapParams,
    pts,
    mask,
    subsample: int = 4,
):
    """Per-particle log-likelihood: project every `subsample`-th scan
    point by the particle pose and evaluate the NDT cell gaussian under
    it (point-to-distribution likelihood, NDT-MCL's measurement
    model)."""
    sp = pts[::subsample]
    sm = mask[::subsample]
    h, w = tgt.valid.shape

    def one(pose):
        world = se2.transform_points(pose, sp)
        rel = (world - tgt.origin) / map_params.resolution
        ix = jnp.floor(rel[..., 0]).astype(jnp.int32)
        iy = jnp.floor(rel[..., 1]).astype(jnp.int32)
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        flat = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
        mu = tgt.means.reshape(-1, 2)[flat]
        cov = tgt.covs.reshape(-1, 2, 2)[flat]
        valid = tgt.valid.reshape(-1)[flat] & inb & sm
        dvec = world - mu
        a = cov[..., 0, 0]
        b = cov[..., 0, 1]
        c = cov[..., 1, 1]
        det = jnp.maximum(a * c - b * b, 1e-12)
        x, y = dvec[..., 0], dvec[..., 1]
        mahal = (c * x * x - 2 * b * x * y + a * y * y) / det
        ll = jnp.where(valid, 0.1 + 0.9 * jnp.exp(-0.5 * mahal), 0.1)
        return jnp.sum(jnp.log(ll) * sm)

    logw = jax.vmap(one)(particles.poses)
    logw = logw - jax.scipy.special.logsumexp(logw)
    return particles._replace(logw=logw)


@jax.jit
def resample(key, particles: ParticleSet):
    """Systematic resampling via inverse CDF."""
    n = particles.poses.shape[0]
    w = jnp.exp(particles.logw - jnp.max(particles.logw))
    w = w / jnp.sum(w)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n)
    us = u0 + jnp.arange(n) / n
    idx = jnp.searchsorted(cdf, us)
    idx = jnp.clip(idx, 0, n - 1)
    return ParticleSet(
        poses=particles.poses[idx], logw=jnp.zeros(n)
    )


@jax.jit
def estimate(particles: ParticleSet):
    """Weighted mean pose (circular mean for theta)."""
    w = jnp.exp(particles.logw - jnp.max(particles.logw))
    w = w / jnp.sum(w)
    xy = jnp.sum(particles.poses[:, :2] * w[:, None], 0)
    s = jnp.sum(jnp.sin(particles.poses[:, 2]) * w)
    c = jnp.sum(jnp.cos(particles.poses[:, 2]) * w)
    return jnp.concatenate([xy, jnp.arctan2(s, c)[None]])


def effective_sample_size(particles: ParticleSet):
    w = jnp.exp(particles.logw - jnp.max(particles.logw))
    w = w / jnp.sum(w)
    return 1.0 / jnp.sum(w * w)


class MCL:
    """Host convenience wrapper: predict → weight → (adaptive)
    resample → estimate."""

    def __init__(self, map_params: NDTMapParams, mp: MotionParams,
                 tgt: d2d.DenseTarget, n_particles=512, seed=0):
        self.map_params = map_params
        self.mp = mp
        self.tgt = tgt
        self.key = jax.random.PRNGKey(seed)
        self.n = n_particles
        self.particles = None

    def _sub(self):
        self.key, k = jax.random.split(self.key)
        return k

    def initialize(self, center, spread_xy=1.0, spread_theta=0.3):
        self.particles = init_uniform(
            self._sub(), self.n, jnp.asarray(center, jnp.float32),
            spread_xy, spread_theta,
        )

    def step(self, Tmotion, pts, mask):
        self.particles = predict(
            self._sub(), self.particles, jnp.asarray(Tmotion), self.mp
        )
        self.particles = weight(
            self.particles, self.tgt, self.map_params, pts, mask
        )
        if float(effective_sample_size(self.particles)) < self.n / 2:
            self.particles = resample(self._sub(), self.particles)
        return estimate(self.particles)
