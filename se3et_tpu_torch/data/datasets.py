r"""Procedural registration pairs (copy of the synthetic generator of
``se3et_tpu/data/datasets.py``: :class:`SyntheticPairDataset` and the two
helpers it calls).  Each pair is a dict with ``ref_points/src_points
(N, 3) float32`` and ``transform (4, 4)``; the fixed-shape pyramid is built
downstream by :mod:`se3et_tpu_torch.data.pipeline`.
"""

from __future__ import annotations

import numpy as np


def random_sample_rotation_v2(rng: np.random.RandomState):
    """Uniform SO(3) rotation (QR of a Gaussian; ``random_sample_rotation_v2``)."""
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q @ np.diag(np.sign(np.diag(r)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def transform_from_rt(rotation, translation):
    tf = np.eye(4)
    tf[:3, :3] = rotation
    tf[:3, 3] = translation
    return tf


class SyntheticPairDataset:
    """Procedural registration pairs for tests, demos and benchmarking when the
    real datasets are not on disk.  Generates partially-overlapping fragments
    of a structured scene (random planes + blobs) with a random rigid motion —
    the same interface as the real datasets."""

    def __init__(self, num_pairs=16, num_points=5000, overlap=0.7, noise=0.002,
                 extent=2.0, seed=0, rotated=True):
        self.num_pairs = num_pairs
        self.num_points = num_points
        self.overlap = overlap
        self.noise = noise
        self.extent = extent
        self.seed = seed
        self.rotated = rotated

    def __len__(self):
        return self.num_pairs

    def __getitem__(self, index):
        rng = np.random.RandomState(self.seed + index)
        # structured scene: a few planes and gaussian clusters.  Feature sizes
        # scale with ``extent`` (plane half-size extent/2, blob sigma
        # extent/8) so the scene is a pure rescaling of the extent-2 case —
        # identical to the historical generator at extent=2.0, and a sane
        # LiDAR-scale proxy at extent=20 (fixed-size 2 m features there would
        # collapse the KITTI voxel pyramid to a handful of points).
        pts = []
        for _ in range(4):
            origin = rng.uniform(-self.extent, self.extent, 3)
            basis = np.linalg.qr(rng.normal(size=(3, 3)))[0][:, :2]
            uv = rng.uniform(-self.extent / 2, self.extent / 2,
                             size=(self.num_points // 6, 2))
            pts.append(origin + uv @ basis.T)
        for _ in range(4):
            center = rng.uniform(-self.extent, self.extent, 3)
            pts.append(center + rng.normal(scale=self.extent / 8,
                                           size=(self.num_points // 12, 3)))
        cloud = np.concatenate(pts, 0)
        rng.shuffle(cloud)

        # two overlapping crops along a random direction
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        proj = cloud @ d
        lo, hi = np.percentile(proj, [5, 95])
        split = lo + (hi - lo) * (1.0 - self.overlap)
        ref = cloud[proj >= split][: self.num_points]
        src = cloud[proj <= hi - (hi - lo) * (1.0 - self.overlap)][: self.num_points]

        rotation = (
            random_sample_rotation_v2(rng) if self.rotated else np.eye(3)
        )
        translation = rng.uniform(-0.5, 0.5, 3)
        src = (src - translation) @ rotation  # src = R^T (ref_region - t)
        ref = ref + rng.normal(scale=self.noise, size=ref.shape)
        src = src + rng.normal(scale=self.noise, size=src.shape)
        return {
            "scene_name": f"synthetic_{index}",
            "ref_points": ref.astype(np.float32),
            "src_points": src.astype(np.float32),
            "transform": transform_from_rt(rotation, translation).astype(np.float32),
        }
