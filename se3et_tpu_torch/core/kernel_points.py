r"""Kernel-point dispositions for KPConv-family convolutions.

TPU-native replacement for ``geotransformer/modules/kpconv/kernel_points.py``.

Two families:

* **Repulsion-optimized dispositions** for the invariant KPConv (kanchor=1):
  points in the unit ball minimizing a Coulomb-like repulsion energy with an
  attraction to the center, one point fixed at the origin ('center' mode) or a
  vertical axis fixed ('verticals' mode).  The reference caches these as
  ``.ply`` under ``kpconv/dispositions``; we regenerate deterministically (fixed
  seed) and cache as ``.npy`` beside this file.  Scaled so the mean non-center
  radius is ~0.66 of the nominal radius, then multiplied by ``radius`` — the
  same normalization as the reference (``kernel_points.py:380-385``).

* **Platonic kernels** for the equivariant E2PN convolution: solid vertices
  (+edge centers / face normals) scaled by 0.66/0.7 of the radius with a center
  point, exactly symmetric under the anchor group so kernel rotation is a
  permutation (``blocks_epn.py:111-179``).
"""

from __future__ import annotations

import os

import numpy as np

from se3et_tpu_torch.core import anchors as anchor_lib

_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dispositions")


def _repulsion_optimize(
    num_points: int,
    dimension: int = 3,
    fixed: str = "center",
    num_iters: int = 10000,
    seed: int = 42,
) -> np.ndarray:
    """Deterministic repulsion optimization of kernel points in the unit ball."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.0, 1.0, size=(num_points, dimension))
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1.0)
    if fixed in ("center", "verticals"):
        pts[0] = 0.0
    if fixed == "verticals":
        pts[:3, :-1] = 0.0
        pts[1, -1] = 0.66
        pts[2, -1] = -0.66

    step = 1e-2
    clip = 0.05
    for it in range(num_iters):
        diff = pts[:, None, :] - pts[None, :, :]
        sq = np.sum(diff**2, axis=-1) + 1e-12
        # inter-point repulsion (inverse-square), plus attraction to center
        rep = diff / (sq[..., None] ** 1.5)
        grad = rep.sum(axis=1) - pts  # attraction gradient is -x
        norms = np.linalg.norm(grad, axis=1, keepdims=True)
        grad = grad / np.maximum(norms, 1e-9) * np.minimum(norms, clip / step)
        moving = np.ones((num_points, 1))
        if fixed in ("center", "verticals"):
            moving[0] = 0.0
        if fixed == "verticals":
            moving[:3] = 0.0
        pts = pts + step * grad * moving
        step *= 0.9995
    # normalize: mean radius of non-fixed points -> 0.66 (ratio used by KPConv)
    r = np.linalg.norm(pts, axis=1)
    scale = 0.66 / np.mean(r[1:])
    return (pts * scale).astype(np.float32)


def _spherical_lloyd(
    num_cells: int,
    dimension: int = 3,
    fixed: str = "center",
    approx_n: int = 20000,
    max_iter: int = 120,
    momentum: float = 0.9,
    seed: int = 42,
) -> np.ndarray:
    """Monte-Carlo Lloyd relaxation of kernel points in the unit ball.

    Deterministic mirror of the reference's ``spherical_Lloyd``
    (``kernel_points.py:62-180``), which the loader switches to for
    ``num_kpoints > 30`` (``kernel_points.py:397-398``): sample the ball
    uniformly, assign samples to the nearest kernel point, move each point to
    its Voronoi cell's centroid with momentum smoothing.  Output at unit
    scale — the loader multiplies by ``radius`` directly (the 0.66 ratio
    applies only to the repulsion family).
    """
    rng = np.random.RandomState(seed)

    def ball_samples(n):
        pts = rng.randn(n, dimension)
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        return pts * rng.rand(n, 1) ** (1.0 / dimension)

    pts = ball_samples(num_cells)
    if fixed in ("center", "verticals"):
        pts[0] = 0.0
    if fixed == "verticals":
        pts[:3, :-1] = 0.0
        pts[1, -1] = 0.5
        pts[2, -1] = -0.5
    vel = np.zeros_like(pts)
    n_fixed = {"none": 0, "center": 1, "verticals": 3}[fixed]
    for _ in range(max_iter):
        samples = ball_samples(approx_n)
        d2 = ((samples[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(axis=1)
        counts = np.bincount(assign, minlength=num_cells)[:, None]
        sums = np.zeros_like(pts)
        np.add.at(sums, assign, samples)
        centroids = np.where(counts > 0, sums / np.maximum(counts, 1), pts)
        vel = momentum * vel + (1.0 - momentum) * (centroids - pts)
        if n_fixed:
            vel[:n_fixed] = 0.0
        pts = pts + vel
    return pts.astype(np.float32)


def load_kernels(
    radius: float,
    num_kpoints: int,
    dimension: int = 3,
    fixed: str = "center",
    equiv_mode: bool = False,
    seed: int | None = None,
    lloyd: bool = False,
) -> np.ndarray:
    """Kernel disposition scaled to ``radius`` (invariant KPConv path).

    With ``equiv_mode=False`` a small random rotation + jitter is applied, as in
    the reference loader (``kernel_points.py:426-455``) — pass a ``seed`` for
    determinism (the engine threads the experiment seed through).  Kernels
    with more than 30 points switch to the Lloyd generator, mirroring the
    reference (``kernel_points.py:397-398``).
    """
    if num_kpoints > 30:
        lloyd = True
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tag = "lloyd_" if lloyd else ""
    cache = os.path.join(
        _CACHE_DIR, f"k_{tag}{num_kpoints:03d}_{fixed}_{dimension}D.npy"
    )
    if os.path.exists(cache):
        pts = np.load(cache)
    else:
        if lloyd:
            pts = _spherical_lloyd(num_kpoints, dimension, fixed)
        else:
            pts = _repulsion_optimize(num_kpoints, dimension, fixed)
        np.save(cache, pts)

    if not equiv_mode:
        rng = np.random.RandomState(0 if seed is None else seed)
        theta = rng.rand() * 2 * np.pi
        if fixed == "verticals":
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
        else:
            phi = (rng.rand() - 0.5) * np.pi
            u = np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
            )
            alpha = rng.rand() * 2 * np.pi
            rot = anchor_lib.rotation_to_z(u) @ anchor_lib.rot_z(alpha) @ anchor_lib.rotation_to_z(u).T
            rot = rot.astype(np.float32)
        pts = pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
        pts = pts @ rot
    return (radius * pts).astype(np.float32)


def so2_symmetric_kernel_points(radius: float, num_kpoints: int, m: int) -> np.ndarray:
    """Kernel points exactly symmetric under m-fold rotation about z.

    For the EPN/E2PN SO(2) modes (``fixed_kernel_points='verticals'`` with
    ``equiv_mode_kp``): a center point, two poles, and rings of m points at
    staggered longitudes/latitudes.  Requires ``(num_kpoints - 3) % m == 0``.
    """
    assert num_kpoints >= 3 and (num_kpoints - 3) % m == 0, (num_kpoints, m)
    num_rings = (num_kpoints - 3) // m
    pts = [np.zeros(3), np.array([0.0, 0.0, 0.66]), np.array([0.0, 0.0, -0.66])]
    # ring latitudes spread in (-60, 60) degrees; radius ~0.66
    lats = np.linspace(-np.pi / 3, np.pi / 3, num_rings) if num_rings > 1 else [0.0]
    for ri, lat in enumerate(lats):
        r = 0.66 * np.cos(lat)
        z = 0.66 * np.sin(lat)
        phase = (ri % 2) * np.pi / m  # stagger alternate rings
        for j in range(m):
            a = 2.0 * np.pi * j / m + phase
            pts.append(np.array([r * np.cos(a), r * np.sin(a), z]))
    out = np.stack(pts, 0) * radius
    return out.astype(np.float32)


def equivariant_kernel_points(
    radius: float, num_kpoints: int, kanchor: int, quotient_factor: int
) -> np.ndarray:
    """Platonic kernel points symmetric under the anchor rotation group.

    Layout matches the reference (``blocks_epn.py:145-173``): solid points
    scaled by 0.66/0.7 of ``radius`` plus a trailing center point.
    """
    order = kanchor * quotient_factor
    if order == 24:  # octahedron (kanchor 6, quotient 4)
        if num_kpoints == 15:
            vts = np.concatenate(
                [anchor_lib.octahedron_vertices(), anchor_lib.octahedron_face_normals()], 0
            )
        elif num_kpoints == 7:
            vts = anchor_lib.octahedron_vertices()
        else:
            raise ValueError(f"octahedron kernel needs K in (7, 15), got {num_kpoints}")
        kernels = vts * 0.7 * radius
    elif order == 12:  # tetrahedron (4,3) or full tetra (12,1)
        assert num_kpoints == 15, num_kpoints
        vts = np.concatenate(
            [
                anchor_lib.tetrahedron_vertices(),
                anchor_lib.tetrahedron_edge_centers(),
                anchor_lib.tetrahedron_face_normals(),
            ],
            0,
        )
        kernels = vts * 0.7 * radius
    elif order == 60:  # icosahedron (12,5) or full icosa (60,1)
        assert num_kpoints == 13, num_kpoints
        kernels = anchor_lib.icosahedron_vertices() * 0.66 * radius
    else:
        raise NotImplementedError(f"group order {order}")
    kernels = np.concatenate([kernels, np.zeros((1, 3))], 0)
    assert kernels.shape[0] == num_kpoints, (kernels.shape, num_kpoints)
    return kernels.astype(np.float32)


def kernel_permutation_tables(
    kernel_points: np.ndarray,
    space: anchor_lib.AnchorSpace,
    ignore_steer_constraint: bool = False,
    radius: float = 1.0,
):
    """Kernel-point permutation under anchors + quotient fold classes.

    Returns:
        kidx_rot: (A, K) int32 — ``kernel[kidx_rot[a, k]] = R_a^{-1} kernel[k]``
        fold: (K,) int32 — map to quotient-orbit representative class
        num_real: int — number of independent kernel classes (K_real)

    Reference: ``blocks_epn.py:228-279`` (including the steerability fold that
    shrinks the weight tensor to K_real classes under the quotient subgroup).
    """
    a_rot = np.einsum("aij,kj->aki", space.anchors, kernel_points)  # R_a K_k
    d = np.linalg.norm(a_rot[:, :, None, :] - kernel_points[None, None, :, :], axis=-1)
    # kidx_rot[a, k1] = k2 with R_a K_k2 ~= K_k1  (argmin over k2 of |R_a K_k2 - K_k1|)
    kidx_rot = d.argmin(axis=1).astype(np.int32)  # (A, K): for each k1 find k2
    res_rot = d.min(axis=1).max()
    res_ori = d.min(axis=2).max()
    tol = 5e-3 * max(radius, 1e-9)
    if res_rot > tol or res_ori > tol:
        raise RuntimeError(
            f"kernel not symmetric under anchors: residual {max(res_rot, res_ori)}"
        )

    num_k = kernel_points.shape[0]
    if space.quotient_factor > 1 and not ignore_steer_constraint:
        q_rot = np.einsum("qij,kj->qki", space.quotient, kernel_points)
        dq = np.linalg.norm(
            q_rot[:, :, None, :] - kernel_points[None, None, :, :], axis=-1
        )
        kidx_q = dq.argmin(axis=1)  # (Q, K): orbit partner of each kernel point
        fold = -np.ones(num_k, dtype=np.int32)
        cls = 0
        for k in range(num_k):
            if fold[k] < 0:
                orbit = set(kidx_q[:, k].tolist()) | {k}
                for m in orbit:
                    fold[m] = cls
                cls += 1
        num_real = cls
    else:
        fold = np.arange(num_k, dtype=np.int32)
        num_real = num_k
    return kidx_rot, fold, num_real


def joint_steerability_classes(
    kernel_points: np.ndarray, space: anchor_lib.AnchorSpace
):
    """Exact steerability constraint: joint H-orbits of (kernel pt, rel anchor).

    The E2PN steerable kernel ``h(x, mu)`` must satisfy ``h(Rx, R mu) = h(x, mu)``
    for every group rotation R; discretized to anchor sections, the weight
    tensor W[k, b] (kernel point x relative-anchor) must be constant on joint
    orbits under the quotient subgroup H acting *diagonally*:

        W[h . k, h . b] = W[k, b]      for all h in H.

    The reference only ties kernel-point orbits (``K_real`` fold,
    ``blocks_epn.py:236-258``) and leaves the anchor axis free, which makes its
    quotient conv only approximately equivariant (verified empirically: with
    the diagonal constraint the anchor-permutation law holds to 1e-6; without
    it no permutation matches).  This framework defaults to the exact
    constraint; the reference parametrization remains available as
    ``steerability='relaxed'``.

    Returns:
        class_idx: (K, A) int32 joint-orbit class of each (k, b) pair
        num_classes: int
    """
    num_k = kernel_points.shape[0]
    a = space.kanchor
    if space.quotient_factor == 1:
        idx = np.arange(num_k * a, dtype=np.int32).reshape(num_k, a)
        return idx, num_k * a

    # H-action permutations on kernel points and anchor vertices
    q = space.quotient.astype(np.float64)
    kperm = np.zeros((q.shape[0], num_k), np.int64)
    aperm = np.zeros((q.shape[0], a), np.int64)
    for qi, h in enumerate(q):
        rk = kernel_points @ h.T
        d = np.linalg.norm(rk[:, None] - kernel_points[None], axis=-1)
        if d.min(axis=1).max() > 1e-3:
            raise RuntimeError("kernel not symmetric under quotient subgroup")
        kperm[qi] = d.argmin(axis=1)
        if space.vertices is not None:
            rv = space.vertices.astype(np.float64) @ h.T
            dv = np.linalg.norm(rv[:, None] - space.vertices[None], axis=-1)
            aperm[qi] = dv.argmin(axis=1)
        else:
            raise NotImplementedError(
                "joint steerability requires sphere-mode anchors; "
                "use steerability='relaxed' for SO(2) quotient mode"
            )

    class_idx = -np.ones((num_k, a), np.int32)
    num_classes = 0
    for k in range(num_k):
        for b in range(a):
            if class_idx[k, b] < 0:
                for qi in range(q.shape[0]):
                    class_idx[kperm[qi, k], aperm[qi, b]] = num_classes
                num_classes += 1
    return class_idx, num_classes
