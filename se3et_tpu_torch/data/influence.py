r"""Host-side precompute of kernel-point influence weights (numpy, fp32).

Port of :mod:`se3et_tpu.data.influence` for the PyTorch package.  Influence
``w[n, h, k] = max(1 - |nbr_h - q_n - kp_k| / sigma, 0)`` is pure geometry,
so it is computed once per (stage, neighbour set) on the host and shared by
every conv of that set.  Unlike the JAX version this one keeps the
neighbour width ``H`` as it is and returns float32: the conv kernels here
index neighbours directly and read ``infl[:, :, :H]``, so they need no
padding of ``H`` to a chunk multiple, and the cast to the compute dtype
happens on the device.

:func:`precompute_influence` stamps the pyramid with the signature of the
configuration it computed for (``influence_sig``), and
:func:`verify_influence` drops influence that does not carry this model's
signature or the port's layout, so that the model computes it on the card
(kernel K15) instead.  The port's signature differs from the JAX package's,
whose influence is bf16 with ``H`` padded.
"""

from __future__ import annotations

import numpy as np

from se3et_tpu_torch.core import kernel_points as kp_lib


def _kernel_points_for(model_cfg, radius: float) -> np.ndarray:
    epn = model_cfg.epn
    if model_cfg.backbone != "e2pn" or epn.kanchor == 1:
        return kp_lib.load_kernels(
            radius, model_cfg.kernel_size, dimension=3, fixed="center",
            equiv_mode=True,
        )
    if epn.fixed_kernel_points == "verticals":
        return kp_lib.so2_symmetric_kernel_points(
            radius, epn.num_kernel_points, epn.kanchor * epn.quotient_factor
        )
    return kp_lib.equivariant_kernel_points(
        radius, epn.num_kernel_points, epn.kanchor, epn.quotient_factor
    )


def _influence_np(q_points, s_points, neighbor_indices, kernel_points, sigma,
                  mode: str) -> np.ndarray:
    """(B, Nq, H, K) float32 influence; sentinel neighbours get zero weight."""
    kernel_points = np.ascontiguousarray(kernel_points, np.float32)
    num_s = s_points.shape[1]
    safe = np.clip(neighbor_indices, 0, num_s - 1)
    nbr = np.stack([s_points[i][safe[i]] for i in range(q_points.shape[0])])
    valid = neighbor_indices < num_s
    rel = nbr - q_points[:, :, None, :]
    rel2 = np.einsum("bnhc,bnhc->bnh", rel, rel)[..., None]
    sq = (rel.reshape(-1, 3) @ kernel_points.T).reshape(
        rel.shape[:3] + (kernel_points.shape[0],)
    )
    # |rel - kp|^2 = |rel|^2 - 2 rel.kp + |kp|^2, built in place
    sq *= np.float32(-2.0)
    sq += rel2
    sq += np.sum(kernel_points**2, axis=-1, dtype=np.float32)
    np.maximum(sq, 0.0, out=sq)
    if mode == "linear":
        np.sqrt(sq, out=sq)
        sq *= np.float32(-1.0 / sigma)
        sq += np.float32(1.0)
        w = np.maximum(sq, 0.0, out=sq)
    elif mode == "constant":
        w = np.ones_like(sq)
    elif mode == "gaussian":
        sq *= np.float32(-1.0 / (2.0 * (sigma * 0.3) ** 2))
        w = np.exp(sq, out=sq)
    else:
        raise ValueError(mode)
    w *= valid[..., None]
    return w.astype(np.float32, copy=False)


def influence_signature(model_cfg) -> np.ndarray:
    """8-byte uint8 signature of every config facet the influence values
    depend on (backbone, stage count, radius and sigma schedule, influence
    mode, kernel-point disposition) and of the port's layout (float32, H
    unpadded)."""
    import hashlib

    epn = model_cfg.epn
    kp_desc = (epn.num_kernel_points, epn.kanchor, epn.quotient_factor,
               epn.fixed_kernel_points, epn.kp_influence)
    desc = repr(("float32, H unpadded", model_cfg.backbone, model_cfg.num_stages,
                 round(float(model_cfg.init_radius), 9), round(float(model_cfg.init_sigma), 9),
                 kp_desc))
    return np.frombuffer(hashlib.sha1(desc.encode()).digest()[:8], np.uint8).copy()


def _neighbor_set(key: str) -> str:
    """The neighbour set an influence key was computed over."""
    kind, st = key[len("influence_"):].rsplit("_", 1)
    return f"neighbors_{st}" if kind == "same" else f"subsampling_{int(st) - 1}"


def verify_influence(data: dict, model_cfg, logger=None) -> dict:
    """Drop the pyramid's precomputed influence unless it carries
    ``model_cfg``'s signature and the port's layout: float32, shaped
    (B, Nq, H, K) over its neighbour set's H.  Without it the model computes
    the influence on the card (kernel K15); a graph captured with host
    influence then refuses the pair.  Host-side, before the pair goes to the
    device.  Returns ``data`` (mutated)."""
    keys = [k for k in data if k.startswith("influence_") and k != "influence_sig"]
    if not keys:
        return data
    sig = np.asarray(data.get("influence_sig", np.zeros(0, np.uint8)))
    expect = influence_signature(model_cfg)
    ok = sig.shape == expect.shape and np.array_equal(sig, expect) and all(
        np.asarray(data[k]).dtype == np.float32
        and np.shape(data[k])[:3] == np.shape(data[_neighbor_set(k)])
        for k in keys)
    if ok:
        return data
    msg = ("the pyramid's influence weights carry another configuration's signature or "
           "layout than this model's (float32, H unpadded); dropping them: the model "
           "computes the influence on the card")
    if logger is not None:
        logger.warning(msg)
    else:
        import warnings

        warnings.warn(msg, stacklevel=2)
    for k in keys + (["influence_sig"] if "influence_sig" in data else []):
        del data[k]
    return data


def precompute_influence(data: dict, model_cfg) -> dict:
    """Add ``influence_same_{st}`` / ``influence_sub_{st}`` (B, Nq, H, K)
    float32 arrays for every conv neighbour set of the backbone, on the
    radius schedule of both backbones: same-level sets at
    ``2^(st-1) * 2 * init`` (stage 0: ``init``), strided sets at
    ``2^(st-1) * init``, and the ``influence_sig`` stamp that
    :func:`verify_influence` checks.  Returns ``data`` (mutated)."""
    r0, s0 = model_cfg.init_radius, model_cfg.init_sigma
    mode = model_cfg.epn.kp_influence if model_cfg.backbone == "e2pn" else "linear"
    pts = [np.asarray(data[f"points_{i}"], np.float32)
           for i in range(model_cfg.num_stages)]

    def one(radius, sigma, q, sup, idx):
        return _influence_np(q, sup, np.asarray(idx),
                             _kernel_points_for(model_cfg, radius), sigma, mode)

    data["influence_same_0"] = one(r0, s0, pts[0], pts[0], data["neighbors_0"])
    for st in range(1, model_cfg.num_stages):
        mult = 2 ** (st - 1)
        data[f"influence_sub_{st}"] = one(
            r0 * mult, s0 * mult, pts[st], pts[st - 1],
            data[f"subsampling_{st - 1}"],
        )
        data[f"influence_same_{st}"] = one(
            r0 * mult * 2, s0 * mult * 2, pts[st], pts[st],
            data[f"neighbors_{st}"],
        )
    data["influence_sig"] = influence_signature(model_cfg)
    return data
