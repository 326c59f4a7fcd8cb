r"""Registration pair datasets of the PyTorch port: copies of
``se3et_tpu/data/datasets.py``'s :class:`ThreeDMatchPairDataset` (3DMatch /
3DLoMatch fragment pairs from the reference's pickle metadata and
``.pth`` / ``.npy`` clouds), the rotation helpers it calls, and the
synthetic generator :class:`SyntheticPairDataset`.  Each pair is a dict
with ``ref_points/src_points (N, 3) float32``, ``transform (4, 4)`` and
metadata; the fixed-shape pyramid is built downstream by
:mod:`se3et_tpu_torch.data.pipeline`.  The KITTI and ModelNet loaders are
not ported.
"""

from __future__ import annotations

import os.path as osp
import pickle

import numpy as np


# --------------------------------------------------------------------------
# augmentation helpers (ports of utils/pointcloud.py)
# --------------------------------------------------------------------------


def random_sample_rotation(rng: np.random.RandomState, factor: float = 1.0):
    """Random axis, angle in [0, 2*pi*factor] (``pointcloud.py random_sample_rotation``)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis) + 1e-12
    angle = rng.rand() * 2.0 * np.pi * factor
    k = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def random_sample_rotation_v2(rng: np.random.RandomState):
    """Uniform SO(3) rotation (QR of a Gaussian; ``random_sample_rotation_v2``)."""
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q @ np.diag(np.sign(np.diag(r)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def random_sample_z_rotation(rng: np.random.RandomState):
    angle = rng.rand() * 2.0 * np.pi
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def transform_from_rt(rotation, translation):
    tf = np.eye(4)
    tf[:3, :3] = rotation
    tf[:3, 3] = translation
    return tf


def _apply_pair_rotation_aug(rng, ref_points, src_points, rotation, translation,
                             factor):
    """Rotate one random cloud of the pair, updating the gt transform
    (``threedmatch/dataset.py:83-103``)."""
    aug = random_sample_rotation(rng, factor)
    if rng.rand() > 0.5:
        ref_points = ref_points @ aug.T
        rotation = aug @ rotation
        translation = aug @ translation
    else:
        src_points = src_points @ aug.T
        rotation = rotation @ aug.T
    return ref_points, src_points, rotation, translation


def _rotate_full(rng, ref_points, src_points, rotation, translation, z_only=False):
    """Independent full-SO(3) (or z-axis) rotations of both clouds — the
    ``rotated``/``z_rotated`` equivariance stress modes
    (``threedmatch/dataset.py:129-147``)."""
    sampler = random_sample_z_rotation if z_only else random_sample_rotation_v2
    ref_rot = sampler(rng)
    ref_points = ref_points @ ref_rot.T
    rotation = ref_rot @ rotation
    translation = ref_rot @ translation
    src_rot = sampler(rng)
    src_points = src_points @ src_rot.T
    rotation = rotation @ src_rot.T
    return ref_points, src_points, rotation, translation


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------


class ThreeDMatchPairDataset:
    """3DMatch / 3DLoMatch fragment pairs (``threedmatch/dataset.py:19-163``).

    subset in {'train', 'val', '3DMatch', '3DLoMatch'} (plus the toy/small/one
    variants which share the metadata format).
    """

    def __init__(
        self,
        dataset_root,
        subset,
        point_limit=None,
        use_augmentation=False,
        augmentation_noise=0.005,
        augmentation_rotation=1.0,
        overlap_threshold=None,
        rotated=False,
        z_rotated=False,
        seed=0,
    ):
        self.dataset_root = dataset_root
        self.metadata_root = osp.join(dataset_root, "metadata")
        self.data_root = osp.join(dataset_root, "data")
        self.subset = subset
        self.point_limit = point_limit
        self.use_augmentation = use_augmentation
        self.aug_noise = augmentation_noise
        self.aug_rotation = augmentation_rotation
        self.rotated = rotated
        self.z_rotated = z_rotated
        self.rng = np.random.RandomState(seed)

        with open(osp.join(self.metadata_root, f"{subset}.pkl"), "rb") as f:
            self.metadata_list = pickle.load(f)
        if overlap_threshold is not None:
            self.metadata_list = [
                x for x in self.metadata_list if x["overlap"] > overlap_threshold
            ]

    def __len__(self):
        return len(self.metadata_list)

    def _load_point_cloud(self, file_name):
        path = osp.join(self.data_root, file_name)
        if path.endswith(".pth"):
            import torch  # lazy; CPU-only read of the reference data format

            points = torch.load(path, map_location="cpu", weights_only=False)
            points = np.asarray(points, dtype=np.float32)
        else:
            points = np.load(path).astype(np.float32)
        if self.point_limit is not None and points.shape[0] > self.point_limit:
            idx = self.rng.permutation(points.shape[0])[: self.point_limit]
            points = points[idx]
        return points

    def __getitem__(self, index):
        meta = self.metadata_list[index]
        rotation = np.asarray(meta["rotation"], np.float64)
        translation = np.asarray(meta["translation"], np.float64)
        ref_points = self._load_point_cloud(meta["pcd0"])
        src_points = self._load_point_cloud(meta["pcd1"])

        if self.use_augmentation:
            ref_points, src_points, rotation, translation = _apply_pair_rotation_aug(
                self.rng, ref_points, src_points, rotation, translation,
                self.aug_rotation,
            )
            ref_points = ref_points + (
                self.rng.rand(*ref_points.shape) - 0.5
            ) * self.aug_noise
            src_points = src_points + (
                self.rng.rand(*src_points.shape) - 0.5
            ) * self.aug_noise
        if self.rotated or self.z_rotated:
            ref_points, src_points, rotation, translation = _rotate_full(
                self.rng, ref_points, src_points, rotation, translation,
                z_only=self.z_rotated,
            )

        return {
            "scene_name": meta.get("scene_name"),
            "ref_frame": meta.get("frag_id0"),
            "src_frame": meta.get("frag_id1"),
            "overlap": meta.get("overlap"),
            "ref_points": ref_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "transform": transform_from_rt(rotation, translation).astype(np.float32),
        }


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
