r"""Host-side (CPU) irregular geometry kernels for the data pipeline.

TPU-native replacement for the reference's C++ extensions
(``geotransformer/extensions/cpu/{grid_subsampling,radius_neighbors}``):

* :func:`grid_subsample` — voxel-grid subsampling that keeps, per voxel, the
  input point closest to the voxel centroid (and carries its normal), matching
  ``grid_subsampling_cpu.cpp:39-70`` bit-for-intent.
* :func:`radius_search` — fixed-width radius neighbor lists sorted by distance
  with sentinel padding (index == num_support), matching
  ``radius_neighbors_cpu.cpp:29-91``.
* :func:`estimate_normals` — KNN-PCA normal estimation replacing the open3d
  dependency (``utils/open3d.py:49-54``, KNN = 33).

These run inside data-loader workers; an optional C++ fast path is provided by
``native/`` (see :mod:`se3et_tpu_torch.data.native_bridge`) with these numpy versions
as the always-available fallback and golden reference.
"""

from __future__ import annotations

import numpy as np

try:  # scipy is available in the image; guard anyway.
    from scipy.spatial import cKDTree

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

from se3et_tpu_torch.data import native_bridge

_USE_NATIVE = native_bridge.available()


def grid_subsample_single(
    points: np.ndarray, voxel_size: float, normals: np.ndarray | None = None
):
    """Voxel-grid subsample one cloud; keep the point closest to voxel centroid.

    Returns (sub_points, sub_normals | None).  Output ordered by voxel hash
    (deterministic).
    """
    points = np.asarray(points, dtype=np.float32)
    if _USE_NATIVE:
        idx = native_bridge.grid_subsample_indices(points, voxel_size)
        return points[idx], (normals[idx] if normals is not None else None)
    min_corner = np.floor(points.min(axis=0) / voxel_size) * voxel_size
    coords = np.floor((points - min_corner) / voxel_size).astype(np.int64)
    dims = coords.max(axis=0) + 1
    keys = coords[:, 0] + dims[0] * coords[:, 1] + dims[0] * dims[1] * coords[:, 2]

    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    uniq, first, counts = np.unique(keys_sorted, return_index=True, return_counts=True)
    inv = np.searchsorted(uniq, keys)  # voxel id per point

    # centroid per voxel
    sums = np.zeros((uniq.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inv, points)
    centroids = sums / counts[:, None]

    # point closest to its voxel centroid
    d2 = np.sum((points - centroids[inv]) ** 2, axis=1)
    best = np.full(uniq.shape[0], -1, dtype=np.int64)
    best_d = np.full(uniq.shape[0], np.inf)
    # vectorized argmin per group: sort by (voxel, distance) and take first
    grp_order = np.lexsort((d2, inv))
    grp_first = np.unique(inv[grp_order], return_index=True)[1]
    best = grp_order[grp_first]

    sub_points = points[best]
    sub_normals = normals[best] if normals is not None else None
    return sub_points, sub_normals


def grid_subsample(
    points: np.ndarray,
    lengths: np.ndarray,
    voxel_size: float,
    normals: np.ndarray | None = None,
):
    """Stack-mode voxel subsampling (multiple clouds concatenated).

    Reference: ``grid_subsampling_cpu.cpp:73-109`` /
    ``modules/ops/grid_subsample.py:7-24``.
    """
    out_points, out_normals, out_lengths = [], [], []
    start = 0
    for length in np.asarray(lengths).tolist():
        cur = points[start : start + length]
        cur_n = normals[start : start + length] if normals is not None else None
        sub, sub_n = grid_subsample_single(cur, voxel_size, cur_n)
        out_points.append(sub)
        if sub_n is not None:
            out_normals.append(sub_n)
        out_lengths.append(sub.shape[0])
        start += length
    points_out = np.concatenate(out_points, axis=0)
    normals_out = np.concatenate(out_normals, axis=0) if out_normals else None
    return points_out, np.asarray(out_lengths, dtype=np.int64), normals_out


def radius_search_single(
    q_points: np.ndarray, s_points: np.ndarray, radius: float, limit: int
) -> np.ndarray:
    """Distance-sorted radius neighbors of one cloud pair, sentinel-padded.

    Returns (len(q_points), limit) int64; sentinel = len(s_points).
    """
    num_s = s_points.shape[0]
    if _USE_NATIVE and num_s > 0:
        return native_bridge.radius_search(q_points, s_points, radius, limit)
    out = np.full((q_points.shape[0], limit), num_s, dtype=np.int64)
    if _HAVE_SCIPY and num_s > 0:
        tree = cKDTree(s_points)
        dists, idx = tree.query(
            q_points, k=min(limit, num_s), distance_upper_bound=radius
        )
        if idx.ndim == 1:
            dists, idx = dists[:, None], idx[:, None]
        valid = np.isfinite(dists)
        idx = np.where(valid, idx, num_s)
        out[:, : idx.shape[1]] = idx
    else:  # brute force fallback
        d2 = np.sum((q_points[:, None] - s_points[None]) ** 2, axis=-1)
        for i in range(q_points.shape[0]):
            nbrs = np.nonzero(d2[i] <= radius * radius)[0]
            nbrs = nbrs[np.argsort(d2[i][nbrs], kind="stable")][:limit]
            out[i, : nbrs.shape[0]] = nbrs
    return out


def radius_search(
    q_points: np.ndarray,
    s_points: np.ndarray,
    q_lengths: np.ndarray,
    s_lengths: np.ndarray,
    radius: float,
    limit: int,
) -> np.ndarray:
    """Stack-mode radius search with global indices and global sentinel.

    Matches ``radius_neighbors_cpu.cpp:29-91`` + the column truncation done in
    ``modules/ops/radius_search.py:7-27``: per batch element a KD-tree query,
    indices offset into the stacked support cloud, missing neighbors filled
    with ``sum(s_lengths)``.
    """
    total_s = int(np.sum(s_lengths))
    rows = []
    q_start = s_start = 0
    for ql, sl in zip(np.asarray(q_lengths).tolist(), np.asarray(s_lengths).tolist()):
        idx = radius_search_single(
            q_points[q_start : q_start + ql],
            s_points[s_start : s_start + sl],
            radius,
            limit,
        )
        sentinel = idx == sl
        idx = idx + s_start
        idx[sentinel] = total_s
        rows.append(idx)
        q_start += ql
        s_start += sl
    return np.concatenate(rows, axis=0)


def morton_order(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Indices sorting points along a Morton (Z-order) space-filling curve.

    Device-side neighbor gathers hit HBM with the point ordering the host
    emits; Morton order makes neighbor indices spatially local so gathers are
    near-sequential (a pure host-side optimization with no semantic effect —
    neighbor lists are built after sorting).
    """
    points = np.asarray(points, np.float64)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    scale = (2**bits - 1) / np.maximum(hi - lo, 1e-9)
    q = ((points - lo) * scale).astype(np.uint64)

    def spread(v):
        v &= np.uint64((1 << bits) - 1)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code, kind="stable")


def estimate_normals(points: np.ndarray, k: int = 33) -> np.ndarray:
    """KNN-PCA surface normals (unoriented, matching open3d's default pipeline).

    Reference: ``utils/open3d.py:49-54`` (KNN search param 33).
    """
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    k = min(k, n)
    if _HAVE_SCIPY:
        tree = cKDTree(points)
        _, idx = tree.query(points, k=k)
    else:  # pragma: no cover
        d2 = np.sum((points[:, None] - points[None]) ** 2, axis=-1)
        idx = np.argsort(d2, axis=1)[:, :k]
    nbrs = points[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    # smallest-eigenvalue eigenvector of each 3x3 covariance
    w, v = np.linalg.eigh(cov)
    normals = v[:, :, 0]
    # deterministic orientation: positive z hemisphere (open3d orients towards
    # an arbitrary consistent direction as well)
    flip = normals[:, 2] < 0
    normals[flip] = -normals[flip]
    return normals.astype(np.float32)


def get_correspondences(
    ref_points: np.ndarray, src_points: np.ndarray, transform: np.ndarray,
    matching_radius: float,
) -> np.ndarray:
    """Ground-truth correspondence pairs within ``matching_radius`` after
    alignment (KD-tree ball query; ``utils/registration.py get_correspondences``).

    Returns (C, 2) int64 [ref_index, src_index] pairs.
    """
    aligned = src_points @ np.asarray(transform)[:3, :3].T + np.asarray(transform)[:3, 3]
    if _HAVE_SCIPY:
        tree = cKDTree(ref_points)
        pairs = []
        hits = tree.query_ball_point(aligned, matching_radius)
        for si, refs in enumerate(hits):
            for ri in refs:
                pairs.append((ri, si))
        if not pairs:
            return np.zeros((0, 2), np.int64)
        return np.asarray(pairs, np.int64)
    d = np.linalg.norm(ref_points[:, None] - aligned[None], axis=-1)
    ri, si = np.nonzero(d < matching_radius)
    return np.stack([ri, si], 1).astype(np.int64)


def knn_single(
    q_points: np.ndarray, s_points: np.ndarray, k: int, cell_hint: float = 0.0
) -> np.ndarray:
    """Distance-sorted k nearest neighbors, sentinel = len(s_points)."""
    num_s = s_points.shape[0]
    k_eff = min(k, num_s)
    if _USE_NATIVE and num_s > 0:
        return native_bridge.knn(q_points, s_points, k, cell_hint)
    out = np.full((q_points.shape[0], k), num_s, dtype=np.int64)
    if num_s == 0:
        return out
    if _HAVE_SCIPY:
        _, idx = cKDTree(s_points).query(q_points, k=k_eff)
        if idx.ndim == 1:
            idx = idx[:, None]
        out[:, :k_eff] = idx
    else:  # brute force
        d2 = np.sum((q_points[:, None] - s_points[None]) ** 2, axis=-1)
        out[:, :k_eff] = np.argsort(d2, axis=1)[:, :k_eff]
    return out


def point_to_node_partition_host(
    points: np.ndarray, nodes: np.ndarray, k: int, cell_hint: float = 0.0
):
    """Voronoi point-to-node partition + per-node k-nearest assigned patches.

    Host-side equivalent of the device op
    (:func:`se3et_tpu.ops.geometry.point_to_node_partition`, itself a port of
    ``modules/ops/pointcloud_partition.py:61-107``).  The partition is pure
    geometry — independent of features and parameters — so the TPU-first
    design computes it in the data pipeline where irregular top-k is cheap,
    instead of paying a device-side (M, N) sort per pair (~22 ms at 3DMatch
    production shapes, dominated by XLA's TopK lowering).

    Exactness: one lexsort by (assigned node, distance) groups every point
    under its Voronoi node in distance order; the first k of each group ARE
    the node's k nearest assigned points — no shortlist, no fallback.

    Returns:
        point_to_node: (N,) int32 nearest-node index
        node_masks: (M,) bool — nodes owning >= 1 point
        knn_idx: (M, k) int64, sentinel N
        knn_masks: (M, k) bool
    """
    n, m = points.shape[0], nodes.shape[0]
    if n == 0 or m == 0:
        return (
            np.zeros(n, np.int32),
            np.zeros(m, bool),
            np.full((m, k), n, np.int64),
            np.zeros((m, k), bool),
        )
    p2n = knn_single(points, nodes, 1, cell_hint)[:, 0].astype(np.int32)
    counts = np.bincount(p2n, minlength=m)
    node_masks = counts > 0

    # exact k-nearest-assigned via ONE lexsort grouped by (node, distance):
    # the k nearest assigned points of a node are the first k entries of its
    # group.  Replaces a 4k-NN hash-grid shortlist (the single hottest host
    # call: ~220 ms/cloud at production shapes vs ~3 ms for the lexsort).
    diff = points - nodes[p2n]
    d2 = np.einsum("nc,nc->n", diff, diff)
    order = np.lexsort((d2, p2n))  # grouped by node, distance-ascending
    offsets = np.concatenate([[0], np.cumsum(counts)])
    take = np.minimum(counts, k)  # per node
    knn_idx = np.full((m, k), n, np.int64)
    knn_masks = np.arange(k)[None, :] < take[:, None]
    # flat positions: for node i, slots 0..take[i) map to order[offsets[i]..]
    rows = np.repeat(np.arange(m), take)
    cols = (np.arange(knn_masks.sum()) -
            np.repeat(np.cumsum(take) - take, take))
    src = (np.repeat(offsets[:-1], take) + cols)
    knn_idx[rows, cols] = order[src]
    return p2n, node_masks, knn_idx, knn_masks
