r"""Rotation-anchor algebra for SE(3)-equivariant point networks (E2PN / EPN).

This module is the TPU-native replacement for the reference anchor machinery
(``geotransformer/modules/transformer/utils_epn/{anchors,rotation}.py`` and the
vendored ``vgtk/functional/rotation.py``).  Everything here is **host-side pure
numpy** executed once at model-construction time; the resulting arrays are baked
into jitted computations as constants.

Design notes (vs. the reference):

* The reference builds platonic rotation groups from ``.ply`` meshes + ZYZ Euler
  formulas with per-solid special cases, then *asserts* group closure at layer
  init (``blocks_epn.py:277-331``).  We instead construct each solid's full
  rotation group *by definition* — the set of rotations that permute the vertex
  set — generated by closure from seed rotations.  Sections (anchor
  representatives of the quotient S2 = SO(3)/SO(2)) are chosen canonically per
  vertex.  All permutation tables are derived from the group action, so the
  closure properties hold by construction; tests assert them anyway.

* All tables are precomputed: the anchor-composition tables used by the E2PN
  convolution (``ridx_rot``/``ridx_ori``, cf. ``blocks_epn.py:281-332``), the
  kernel-point permutation and quotient-fold tables (``kidx_rot``/``K_real``,
  cf. ``blocks_epn.py:228-279``), and the vertex-permutation tables used by the
  equivariant attention (``trace_idx_ori``/``trace_idx_rot``, cf.
  ``vgtk/functional/rotation.py:566-601``).

Supported anchor configurations (matching the reference, `blocks_epn.py:133-144`):

==========  ==============  ====================================================
kanchor A   quotient Q      group
==========  ==============  ====================================================
1           1               trivial (plain KPConv)
2..9        1               C_A, rotations about z (EPN SO(2) mode)
A           Q>1 (z-mode)    C_{A*Q} quotient C_Q (E2PN SO(2) mode)
4           3               tetrahedral group A4 (12), vertices as anchors
6           4               octahedral group O (24), vertices as anchors
12          5               icosahedral group I (60), vertices as anchors
12          1               full tetrahedral group as anchor set (EPN)
60          1               full icosahedral group as anchor set (EPN)
==========  ==============  ====================================================
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

_EPS = 1e-5


# ---------------------------------------------------------------------------
# Elementary rotations
# ---------------------------------------------------------------------------


def rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=np.float64)


def rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=np.float64)


def anchors_z(k: int) -> np.ndarray:
    """k rotations about the z axis (cyclic group C_k), float32 (k,3,3)."""
    angles = np.linspace(0.0, 2.0 * np.pi, k, endpoint=False)
    return np.stack([rot_z(a) for a in angles], 0).astype(np.float32)


def rotation_to_z(v: np.ndarray) -> np.ndarray:
    """A rotation mapping e_z to unit vector ``v`` (ZYZ: Rz(alpha) Ry(beta))."""
    v = np.asarray(v, dtype=np.float64)
    v = v / np.linalg.norm(v)
    beta = np.arccos(np.clip(v[2], -1.0, 1.0))
    if abs(v[2]) > 1.0 - 1e-9:
        alpha = 0.0
    else:
        alpha = np.arctan2(v[1], v[0])
    return rot_z(alpha) @ rot_y(beta)


# ---------------------------------------------------------------------------
# Platonic solids
# ---------------------------------------------------------------------------


def tetrahedron_vertices() -> np.ndarray:
    """4 unit vertices of a regular tetrahedron with one vertex at +z.

    Same placement as the reference (`utils_epn/rotation.py:525-531`).
    """
    v = np.array(
        [
            [0.0, 0.0, 3.0],
            [2.0 * np.sqrt(2.0), 0.0, -1.0],
            [-np.sqrt(2.0), np.sqrt(6.0), -1.0],
            [-np.sqrt(2.0), -np.sqrt(6.0), -1.0],
        ]
    )
    return v / 3.0


def octahedron_vertices() -> np.ndarray:
    """6 unit vertices of a regular octahedron, axis-aligned.

    Same order as the reference (`utils_epn/rotation.py:484-490`).
    """
    return np.array(
        [
            [0.0, 0.0, 1.0],
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [-1.0, 0.0, 0.0],
            [0.0, -1.0, 0.0],
            [0.0, 0.0, -1.0],
        ]
    )


def icosahedron_vertices() -> np.ndarray:
    """12 unit vertices of a regular icosahedron with vertices at ±z.

    Pole at +z, upper ring of 5 at z=+1/sqrt(5), lower ring (offset 36°) at
    -1/sqrt(5), pole at -z.
    """
    zr = 1.0 / np.sqrt(5.0)
    rr = 2.0 / np.sqrt(5.0)
    verts = [np.array([0.0, 0.0, 1.0])]
    for i in range(5):
        a = 2.0 * np.pi * i / 5.0
        verts.append(np.array([rr * np.cos(a), rr * np.sin(a), zr]))
    for i in range(5):
        a = 2.0 * np.pi * i / 5.0 + np.pi / 5.0
        verts.append(np.array([rr * np.cos(a), rr * np.sin(a), -zr]))
    verts.append(np.array([0.0, 0.0, -1.0]))
    return np.stack(verts, 0)


def octahedron_face_normals() -> np.ndarray:
    """8 unit face normals of the octahedron: (±1,±1,±1)/sqrt(3)."""
    signs = np.array(
        [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)],
        dtype=np.float64,
    )
    return signs / np.sqrt(3.0)


def tetrahedron_edge_centers() -> np.ndarray:
    v = tetrahedron_vertices()
    ecs = []
    for i in range(4):
        for j in range(i + 1, 4):
            ec = 0.5 * (v[i] + v[j])
            ecs.append(ec / np.linalg.norm(ec))
    return np.stack(ecs, 0)


def tetrahedron_face_normals() -> np.ndarray:
    """Face normals of the regular tetrahedron = negated opposite vertices."""
    return -tetrahedron_vertices()


# ---------------------------------------------------------------------------
# Group construction
# ---------------------------------------------------------------------------


def _permutes_set(rot: np.ndarray, pts: np.ndarray, tol: float = 1e-4) -> bool:
    """True if ``rot`` maps the point set onto itself (bijectively)."""
    rotated = pts @ rot.T
    d = np.linalg.norm(rotated[:, None, :] - pts[None, :, :], axis=-1)
    match = d.min(axis=1)
    if match.max() > tol:
        return False
    idx = d.argmin(axis=1)
    return len(set(idx.tolist())) == pts.shape[0]


def _unique_rotations(rots: list[np.ndarray], tol: float = 1e-4) -> list[np.ndarray]:
    out: list[np.ndarray] = []
    for r in rots:
        if not any(np.abs(r - o).max() < tol for o in out):
            out.append(r)
    return out


@functools.lru_cache(maxsize=None)
def _solid_group(solid: str) -> tuple[np.ndarray, np.ndarray]:
    """Full rotation group of a platonic solid with a vertex at +z.

    Returns:
        vertices: (V, 3) float64
        group: (G, 3, 3) float64 rotation matrices, closed under composition.
    """
    if solid == "tetrahedron":
        verts, stab = tetrahedron_vertices(), 3
    elif solid == "octahedron":
        verts, stab = octahedron_vertices(), 4
    elif solid == "icosahedron":
        verts, stab = icosahedron_vertices(), 5
    else:
        raise ValueError(solid)

    # Seed rotations: for each vertex v, candidates Rz(a) Ry(b) Rz(g + off)
    # mapping z -> v, for all stabilizer angles g and phase offsets off.  Keep
    # those that are exact symmetries, then close under multiplication.
    seeds: list[np.ndarray] = []
    offsets = np.linspace(0.0, 2.0 * np.pi / stab, 2 * stab, endpoint=False)
    for v in verts:
        base = rotation_to_z(v)
        for g in range(stab):
            gamma = 2.0 * np.pi * g / stab
            for off in offsets:
                r = base @ rot_z(gamma + off)
                if _permutes_set(r, verts):
                    seeds.append(r)
    group = _unique_rotations(seeds)
    # Closure (one pass suffices for these groups given all coset reps present,
    # but iterate to a fixed point for safety).
    while True:
        products = [a @ b for a in group for b in group]
        new_group = _unique_rotations(group + products)
        if len(new_group) == len(group):
            break
        group = new_group
    expected = {"tetrahedron": 12, "octahedron": 24, "icosahedron": 60}[solid]
    if len(group) != expected:
        raise RuntimeError(f"{solid}: built group of order {len(group)} != {expected}")
    return verts, np.stack(group, 0)


def _order_group_by_vertex(
    verts: np.ndarray, group: np.ndarray, stab: int
) -> np.ndarray:
    """Order group elements as (V, stab): block a holds rotations with R e_z = v_a.

    Within a block, the canonical section representative (the one whose
    stabilizer angle gamma is smallest, i.e. closest to the plain ZYZ map
    Rz(a)Ry(b)) comes first; the rest follow in increasing gamma order so that
    block a, slot g is R_a^sec @ Rz(gamma_g') for an increasing sequence.
    """
    ez = np.array([0.0, 0.0, 1.0])
    ordered = []
    for a, v in enumerate(verts):
        members = [g for g in range(group.shape[0]) if np.linalg.norm(group[g] @ ez - v) < 1e-4]
        if len(members) != stab:
            raise RuntimeError(f"vertex {a}: {len(members)} stabilizer cosets != {stab}")
        base = rotation_to_z(v)
        # gamma of member m: base^T @ R_m is a rotation about z; recover angle.
        def gamma_of(m: int) -> float:
            rz = base.T @ group[m]
            ang = np.arctan2(rz[1, 0], rz[0, 0])
            return float(np.mod(ang, 2.0 * np.pi))

        members.sort(key=gamma_of)
        ordered.extend(members)
    return group[np.array(ordered)]


# ---------------------------------------------------------------------------
# Permutation tables
# ---------------------------------------------------------------------------


def rotation_composition_tables(
    anchors: np.ndarray, quotient: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Anchor-composition permutation tables for the E2PN convolution.

    With sections R_a and stabilizer subgroup H = {Q_d}:

    * ``ridx_ori[r, b] = a``  such that  R_a H = R_r R_b H
    * ``ridx_rot[a, r] = b``  such that  R_r R_b H = R_a H   (inverse perm)

    These reproduce the tables asserted at ``blocks_epn.py:281-332``; the
    indexing convention matches the buffers registered there (``ridx_rot`` is
    indexed ``[a, r]`` after the reference's transpose).
    """
    prod = np.einsum("aij,bjk->abik", anchors, anchors)  # R_a R_b
    # coset distance: max over H of closeness between R_c Q_d and R_a R_b
    all_anchors = np.einsum("aij,djk->adik", anchors, quotient)  # R_c Q_d
    tr = np.einsum("cdji,abjk->cdabik", all_anchors, prod)
    cos = 0.5 * (np.einsum("cdabii->cdab", tr) - 1.0)
    cos = cos.max(axis=1)  # cab
    ridx_ori = cos.argmax(axis=0)  # (a=r?, b) -> c : for product R_r R_b
    # cos[c, r, b]: closeness of anchor c to R_r R_b
    res_ori = cos.max(axis=0)
    ridx_rot = cos.argmax(axis=2)  # [c, r] -> b with R_r R_b in R_c H
    res_rot = cos.max(axis=2)
    if np.abs(res_ori - 1.0).max() > 1e-3 or np.abs(res_rot - 1.0).max() > 1e-3:
        raise RuntimeError("anchor set not closed under composition (mod quotient)")
    return ridx_ori.astype(np.int32), ridx_rot.astype(np.int32)


def vertex_trace_tables(
    rotations: np.ndarray, vertices: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Vertex permutations under the full rotation set (attention tables).

    * ``trace_idx_ori[r, a] = u`` with ``v_u = R_r v_a``
    * ``trace_idx_rot[r, u] = a`` with ``R_r v_a = v_u``

    Reference: ``vgtk/functional/rotation.py:581-601``.
    """
    rotated = np.einsum("rij,aj->rai", rotations, vertices)
    d = np.linalg.norm(rotated[:, :, None, :] - vertices[None, None, :, :], axis=-1)
    trace_idx_ori = d.argmin(axis=2)
    trace_idx_rot = d.argmin(axis=1)
    if d.min(axis=2).max() > 1e-3 or d.min(axis=1).max() > 1e-3:
        raise RuntimeError("rotations do not permute the vertex set")
    return trace_idx_ori.astype(np.int32), trace_idx_rot.astype(np.int32)


def rotation_trace_tables(rotations: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Group-element permutations under left multiplication (kanchor=3 mode).

    ``trace_idx_ori[r, a] = u`` with ``R_u = R_r R_a``;
    ``trace_idx_rot[r, u] = a`` with ``R_r R_a = R_u`` (transposed convention to
    match the reference's kanchor==3 branch, `vanilla_transformer.py:227-240`).
    """
    prod = np.einsum("rij,ajk->raik", rotations, rotations)
    tr = np.einsum("uji,rajk->uraik", rotations, prod)
    cos = 0.5 * (np.einsum("uraii->ura", tr) - 1.0)
    trace_idx_ori = cos.argmax(axis=0)  # (r, a) -> u
    trace_idx_rot = np.argmax(cos, axis=2).T  # (u, r) -> a, transposed -> (r, u)
    return trace_idx_ori.astype(np.int32), trace_idx_rot.astype(np.int32)


def vertex_adjacency(vertices: np.ndarray) -> np.ndarray:
    """Indices of each vertex's nearest neighbors (same count per vertex)."""
    d = np.linalg.norm(vertices[:, None] - vertices[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    nearest = d.min()
    adj = [np.nonzero(row < nearest + 1e-4)[0] for row in d]
    n = min(len(a) for a in adj)
    return np.stack([a[:n] for a in adj], 0).astype(np.int32)


# ---------------------------------------------------------------------------
# Anchor space dataclass
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnchorSpace:
    """Frozen anchor configuration consumed by conv / attention layers."""

    kanchor: int
    quotient_factor: int
    mode: str  # 'trivial' | 'so2' | 'sphere' | 'so3'
    anchors: np.ndarray  # (A, 3, 3) float32 section representatives
    quotient: np.ndarray  # (Q, 3, 3) float32 stabilizer subgroup
    rotations: np.ndarray  # (R, 3, 3) float32 full rotation set, R = A*Q
    vertices: np.ndarray | None  # (A, 3) float32 (sphere mode only)
    ridx_ori: np.ndarray  # (A, A) int32 composition table
    ridx_rot: np.ndarray  # (A, A) int32 inverse composition table [a, r] -> b
    trace_idx_ori: np.ndarray | None  # (R, A) int32
    trace_idx_rot: np.ndarray | None  # (R, A) int32
    intra_idx: np.ndarray | None  # (A, K_intra) int32 adjacency in anchor space
    v_adjs: np.ndarray | None  # (A, deg) int32 vertex adjacency

    @property
    def num_rotations(self) -> int:
        return self.rotations.shape[0]


@functools.lru_cache(maxsize=None)
def get_anchor_space(kanchor: int, quotient_factor: int = 1) -> AnchorSpace:
    """Build the anchor space for a (kanchor, quotient_factor) configuration."""
    if kanchor == 1:
        eye = np.eye(3, dtype=np.float32)[None]
        return AnchorSpace(
            kanchor=1,
            quotient_factor=1,
            mode="trivial",
            anchors=eye,
            quotient=eye,
            rotations=eye,
            vertices=None,
            ridx_ori=np.zeros((1, 1), np.int32),
            ridx_rot=np.zeros((1, 1), np.int32),
            trace_idx_ori=np.zeros((1, 1), np.int32),
            trace_idx_rot=np.zeros((1, 1), np.int32),
            intra_idx=np.zeros((1, 1), np.int32),
            v_adjs=None,
        )

    solids = {(4, 3): "tetrahedron", (6, 4): "octahedron", (12, 5): "icosahedron"}
    full = {12: "tetrahedron", 60: "icosahedron"}

    if (kanchor, quotient_factor) in solids:
        solid = solids[(kanchor, quotient_factor)]
        verts, group = _solid_group(solid)
        group = _order_group_by_vertex(verts, group, quotient_factor)
        anchors = group.reshape(kanchor, quotient_factor, 3, 3)[:, 0]
        quotient = anchors_z(quotient_factor).astype(np.float64)
        ridx_ori, ridx_rot = rotation_composition_tables(anchors, quotient)
        trace_ori, trace_rot = vertex_trace_tables(group, verts)
        v_adjs = vertex_adjacency(verts)
        return AnchorSpace(
            kanchor=kanchor,
            quotient_factor=quotient_factor,
            mode="sphere",
            anchors=anchors.astype(np.float32),
            quotient=quotient.astype(np.float32),
            rotations=group.astype(np.float32),
            vertices=verts.astype(np.float32),
            ridx_ori=ridx_ori,
            ridx_rot=ridx_rot,
            trace_idx_ori=trace_ori,
            trace_idx_rot=trace_rot,
            intra_idx=v_adjs,
            v_adjs=v_adjs,
        )

    if quotient_factor == 1 and kanchor in full:
        solid = full[kanchor]
        verts, group = _solid_group(solid)
        stab = {12: 3, 60: 5}[kanchor]
        group = _order_group_by_vertex(verts, group, stab)
        anchors = group
        quotient = np.eye(3)[None]
        ridx_ori, ridx_rot = rotation_composition_tables(anchors, quotient)
        trace_ori, trace_rot = rotation_trace_tables(anchors)
        # intra adjacency: nearest rotations by geodesic distance
        tr = np.einsum("aji,bjk->abik", anchors, anchors)
        cos = 0.5 * (np.einsum("abii->ab", tr) - 1.0)
        np.fill_diagonal(cos, -2.0)
        order = np.argsort(-cos, axis=1)
        deg = {12: 7, 60: 12}[kanchor]
        intra = order[:, :deg].astype(np.int32)
        return AnchorSpace(
            kanchor=kanchor,
            quotient_factor=1,
            mode="so3",
            anchors=anchors.astype(np.float32),
            quotient=quotient.astype(np.float32),
            rotations=anchors.astype(np.float32),
            vertices=None,
            ridx_ori=ridx_ori,
            ridx_rot=ridx_rot,
            trace_idx_ori=trace_ori,
            trace_idx_rot=trace_rot,
            intra_idx=intra,
            v_adjs=None,
        )

    if 2 <= kanchor <= 9:
        # SO(2) mode: cyclic group about z, optionally with quotient.
        anchors = anchors_z(kanchor * quotient_factor)[:kanchor].astype(np.float64)
        # NOTE: with Q>1 the anchors are the first A elements of C_{A*Q}; the
        # stabilizer is C_Q embedded as rotations by multiples of 2*pi/Q.
        quotient = anchors_z(quotient_factor).astype(np.float64)
        full_set = anchors_z(kanchor * quotient_factor).astype(np.float64)
        ridx_ori, ridx_rot = rotation_composition_tables(anchors, quotient)
        if quotient_factor == 1:
            trace_ori, trace_rot = rotation_trace_tables(anchors)
        else:
            trace_ori = trace_rot = None
        k = kanchor
        intra = np.stack([(np.arange(k) + i) % k for i in range(k)], 0).astype(np.int32)
        return AnchorSpace(
            kanchor=kanchor,
            quotient_factor=quotient_factor,
            mode="so2",
            anchors=anchors.astype(np.float32),
            quotient=quotient.astype(np.float32),
            rotations=full_set.astype(np.float32),
            vertices=None,
            ridx_ori=ridx_ori,
            ridx_rot=ridx_rot,
            trace_idx_ori=trace_ori,
            trace_idx_rot=trace_rot,
            intra_idx=intra,
            v_adjs=None,
        )

    raise NotImplementedError(f"kanchor={kanchor}, quotient_factor={quotient_factor}")


# ---------------------------------------------------------------------------
# Rotation labeling (rotation supervision)
# ---------------------------------------------------------------------------


def label_relative_rotation(rotations: np.ndarray, rot: np.ndarray):
    """Nearest group rotation to ``rot``: (residual_target, label).

    ``rot ≈ residual_target @ rotations[label]`` with the residual closest to
    identity.  Reference: ``vgtk/functional/rotation.py`` /
    ``label_relative_rotation_simple``.
    """
    tr = np.einsum("aji,jk->aik", rotations, rot)
    cos = 0.5 * (np.einsum("aii->a", tr) - 1.0)
    label = int(cos.argmax())
    target = rot @ rotations[label].T
    return target, label
