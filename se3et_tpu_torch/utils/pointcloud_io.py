r"""Point-cloud file IO and visualisation dumps (no open3d dependency): a
copy of :mod:`se3et_tpu.utils.pointcloud_io`, kept for the PyTorch port,
which imports nothing of the JAX package (``tests/test_torch_shared_copies.py``
holds the two equal).  Coloured clouds and correspondence line sets are
written as standard ``.ply`` files any viewer opens.
"""

from __future__ import annotations

import struct

import numpy as np


def write_ply(path, points, colors=None, normals=None):
    """Write a binary little-endian PLY with optional per-point color/normal."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(np.asarray(normals, np.float32))
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        props += [
            "property uchar red", "property uchar green", "property uchar blue"
        ]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        float_part = np.concatenate(cols, axis=1).astype("<f4")
        if colors is not None:
            row_fmt = float_part.shape[1]
            for i in range(n):
                f.write(float_part[i].tobytes())
                f.write(colors[i].tobytes())
        else:
            f.write(float_part.tobytes())


def read_ply(path):
    """Read ascii or binary-LE PLY vertices (x, y, z [+ extras ignored])."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header if l.startswith("format")).split()[1]
        n = int(next(l for l in header if l.startswith("element vertex")).split()[2])
        props = [l.split() for l in header if l.startswith("property")]
        names = [p[2] for p in props]
        types = [p[1] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            data = np.atleast_2d(data)
            xyz = data[:, [names.index("x"), names.index("y"), names.index("z")]]
            return xyz.astype(np.float32)
        type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}
        dtype = np.dtype([(nm, type_map[t]) for nm, t in zip(names, types)])
        arr = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        return np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)


def feature_colors(feats, seed=0):
    """3-D PCA embedding of features -> RGB in [0,1] (t-SNE substitute used for
    qualitative feature visualization, ``utils/visualization.py:14-50``)."""
    feats = np.asarray(feats, np.float64)
    feats = feats - feats.mean(axis=0)
    u, s, vt = np.linalg.svd(feats, full_matrices=False)
    emb = feats @ vt[:3].T
    emb = emb - emb.min(axis=0)
    emb = emb / (emb.max(axis=0) + 1e-12)
    return emb.astype(np.float32)


def write_correspondence_ply(path, ref_points, src_points, max_lines=500):
    """Correspondences as a PLY line set (edge elements)."""
    ref_points = np.asarray(ref_points, np.float32)[:max_lines]
    src_points = np.asarray(src_points, np.float32)[:max_lines]
    n = ref_points.shape[0]
    verts = np.concatenate([ref_points, src_points], axis=0)
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {2 * n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element edge {n}\nproperty int vertex1\nproperty int vertex2\n"
        "end_header\n"
    )
    with open(path, "w") as f:
        f.write(header)
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for i in range(n):
            f.write(f"{i} {i + n}\n")
