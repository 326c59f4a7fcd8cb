r"""Real spherical harmonics + Wigner-D matrices for low degrees (l <= 2).

Hand-rolled replacement for the reference's e3nn dependency
(``modules/geotransformer/geotransformer.py:4,40-67``), which it uses only for
degree-0..2 spherical harmonics of pair directions and per-anchor Wigner-D
rotations of those harmonics.

Conventions follow e3nn: real SH in the (y, z, x) ordering for l=1, 'integral'
normalization (so rotating the input rotates the SH vector by the Wigner-D of
the same rotation: ``Y_l(R x) = D_l(R) Y_l(x)``).
"""

from __future__ import annotations

import numpy as np

_P_YZX = np.array(
    [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]
)  # maps (x,y,z) -> (y,z,x)


def sh_dim(l: int) -> int:
    return 2 * l + 1


def real_sh(degrees: list[int], vectors, xp=np):
    """Real spherical harmonics of unit(vectors), concatenated over degrees.

    Args:
        vectors: (..., 3) array (need not be normalized; normalized internally)
        xp: numpy or jax.numpy

    Returns:
        (..., sum(2l+1)) array.
    """
    eps = 1e-12
    n = xp.sqrt(xp.sum(vectors**2, axis=-1, keepdims=True))
    v = vectors / (n + eps)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    out = []
    for l in degrees:
        if l == 0:
            out.append(xp.full(x.shape + (1,), 0.5 / np.sqrt(np.pi), dtype=vectors.dtype))
        elif l == 1:
            c = np.sqrt(3.0 / (4.0 * np.pi))
            out.append(xp.stack([c * y, c * z, c * x], axis=-1))
        elif l == 2:
            c = np.sqrt(15.0 / (4.0 * np.pi))
            c20 = np.sqrt(5.0 / (16.0 * np.pi))
            out.append(
                xp.stack(
                    [
                        c * x * y,
                        c * y * z,
                        c20 * (3.0 * z**2 - 1.0),
                        c * x * z,
                        0.5 * c * (x**2 - y**2),
                    ],
                    axis=-1,
                )
            )
        else:
            raise NotImplementedError(f"degree {l}")
    return xp.concatenate(out, axis=-1)


def wigner_d(l: int, rotation: np.ndarray) -> np.ndarray:
    """Wigner-D matrix of a 3x3 rotation for degree l (real basis, e3nn order).

    Satisfies ``Y_l(R x) = D_l(R) Y_l(x)`` with :func:`real_sh`.
    """
    rotation = np.asarray(rotation, dtype=np.float64)
    if l == 0:
        return np.ones((1, 1))
    if l == 1:
        return _P_YZX @ rotation @ _P_YZX.T
    if l == 2:
        # Numerically construct from the SH transformation property: sample
        # directions, solve the linear map D = Y(Rx) Y(x)^+ exactly (l=2 spans
        # a 5-dim space; 6+ generic samples suffice).
        rng = np.random.RandomState(0)
        dirs = rng.normal(size=(32, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        y = real_sh([2], dirs)  # (32, 5)
        yr = real_sh([2], dirs @ rotation.T)  # (32, 5)
        d, *_ = np.linalg.lstsq(y, yr, rcond=None)
        return d.T
    raise NotImplementedError(f"degree {l}")


def anchor_wigner_d(degrees: list[int], anchors: np.ndarray) -> list[np.ndarray]:
    """Per-anchor Wigner-D blocks D_l(R_a^T), as used by the reference's
    equivariant embedding (``geotransformer.py:50-54`` rotates by the anchor
    inverse)."""
    return [
        np.stack([wigner_d(l, r.T) for r in anchors], 0).astype(np.float32)
        for l in degrees
    ]
