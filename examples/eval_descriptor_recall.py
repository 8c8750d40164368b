"""Descriptor-statistic parity study.

flirtlib's BetaGrid carries hit/miss counts and a variance per bin and
chi2-compares histograms (flirtlib_ros/src/conversions.cpp:234-258);
our descriptor emits the Beta posterior mean per bin by default.  This
study measures what actually matters — RANSAC pose-recovery recall —
for both statistics ("beta_mean" vs "hitmiss": separately-normalized
hit and miss histograms, chi2 = average of the per-histogram chi2s)
across range regimes (features at ~2 m to ~15+ m) and viewpoint
offsets on randomized worlds.

Prints a markdown table for EVAL.md.  CPU-friendly.
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

from ndt_feature_graph_tpu.config import FeatureParams
from ndt_feature_graph_tpu.core import se2
from ndt_feature_graph_tpu.features import describe, detect, match_sets
from ndt_feature_graph_tpu.io import dataset

# Range regimes: world half-extents + sensor range set typical feature
# distances (near ~2-5 m, mid ~5-10 m, far ~8-15+ m).
REGIMES = {
    "near": dict(half_x=4.0, half_y=3.0, max_range=6.0, beams=360),
    "mid": dict(half_x=10.0, half_y=7.0, max_range=15.0, beams=360),
    "far": dict(half_x=20.0, half_y=14.0, max_range=30.0, beams=720),
}
STATS = ["beta_mean", "hitmiss"]
N_PAIRS = 30


def recall(stat, regime, n_pairs=N_PAIRS):
    cfg = REGIMES[regime]
    fp = FeatureParams(
        num_beams=cfg["beams"],
        max_range=cfg["max_range"],
        descriptor_stat=stat,
    )
    hits = 0
    feat_dists = []
    for seed in range(n_pairs):
        world, traj = dataset.random_loop_scenario(
            7000 + seed, n_steps=40,
            half_x=cfg["half_x"], half_y=cfg["half_y"],
        )
        rng = np.random.default_rng(8000 + seed)
        pose1 = traj[rng.integers(len(traj))]
        off = jnp.asarray(
            [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5),
             rng.uniform(-0.3, 0.3)], jnp.float32)
        pose2 = se2.compose(pose1, off)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)

        def feats(pose, k):
            r, h = dataset.raycast(
                world, pose, cfg["beams"], cfg["max_range"]
            )
            r = r + 0.01 * jax.random.normal(k, r.shape) * h
            f = detect(fp, r, h)
            return f, describe(fp, f, r, h)

        f1, d1 = feats(pose1, k1)
        f2, d2 = feats(pose2, k2)
        m = np.asarray(f1.mask)
        if m.any():
            feat_dists.append(
                float(np.linalg.norm(np.asarray(f1.pts)[m], axis=-1).mean())
            )
        expect = np.asarray(se2.sub(pose1, pose2))
        res = match_sets(fp, f1, d1, f2, d2, k3)
        got = np.asarray(res.T)
        ok = (
            bool(res.valid)
            and np.linalg.norm(got[:2] - expect[:2]) < 0.25
            and abs(float(se2.normalize_angle(got[2] - expect[2]))) < 0.1
        )
        hits += int(ok)
    return hits / n_pairs, float(np.mean(feat_dists))


def main():
    print(f"| regime | mean feat dist (m) | " + " | ".join(STATS) + " |")
    print("|---|---|" + "---|" * len(STATS))
    for regime in REGIMES:
        row = []
        fd = None
        for stat in STATS:
            r, fd = recall(stat, regime)
            row.append(f"{r:.2f}")
        print(f"| {regime} | {fd:.1f} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
