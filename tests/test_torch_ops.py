"""Ops, layers and host helpers of the PyTorch port against the JAX package,
on the CPU (same numpy inputs on both sides, float32)."""

import numpy as np
import pytest
import torch

from se3et_tpu_torch.core import se3 as tse3
from se3et_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("normalized", [False, True])
def test_pairwise_distance(normalized):
    from se3et_tpu.ops import geometry

    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 30, 8)).astype(np.float32)
    y = rng.normal(size=(2, 20, 8)).astype(np.float32)
    if normalized:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        y /= np.linalg.norm(y, axis=-1, keepdims=True)
    want = np.asarray(geometry.pairwise_distance(x, y, normalized=normalized))
    got = tgeo.pairwise_distance(_t(x), _t(y), normalized=normalized).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gather_with_sentinel_masks_out_of_range():
    from se3et_tpu.ops import geometry

    rng = np.random.RandomState(1)
    vals = rng.normal(size=(10, 3)).astype(np.float32)
    idx = np.array([[0, 9, 10], [-1, 4, 10]], np.int32)  # 10 = sentinel
    want = np.asarray(geometry.gather_with_sentinel(vals, idx, pad_value=-2.0))
    got = tgeo.gather_with_sentinel(_t(vals), _t(idx), pad_value=-2.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["masked_softmax", "masked_mean", "masked_max"])
def test_masked_ops(op):
    from se3et_tpu.ops import geometry

    rng = np.random.RandomState(2)
    x = rng.normal(size=(4, 7)).astype(np.float32)
    mask = rng.rand(4, 7) > 0.4
    mask[0] = True
    mask[1, 0] = True
    if op == "masked_softmax":
        mask[2] = False  # fully masked row -> zeros
        want = geometry.masked_softmax(x, mask, axis=-1)
        got = tgeo.masked_softmax(_t(x), _t(mask), dim=-1)
    elif op == "masked_mean":
        want = geometry.masked_mean(x, mask, axis=-1)
        got = tgeo.masked_mean(_t(x), _t(mask), dim=-1)
    else:
        want = geometry.masked_max(x, mask, axis=-1)
        got = tgeo.masked_max(_t(x), _t(mask), dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_weighted_procrustes_and_transforms():
    from se3et_tpu.core import se3

    rng = np.random.RandomState(3)
    src = rng.normal(size=(5, 40, 3)).astype(np.float32)
    ref = src @ np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32).T + 0.3
    ref += rng.normal(scale=0.01, size=ref.shape).astype(np.float32)
    w = rng.rand(5, 40).astype(np.float32)
    w[0] = 0.0  # degenerate weights must stay finite
    want = np.asarray(se3.weighted_procrustes(src, ref, w))
    got = tse3.weighted_procrustes(_t(src), _t(ref), _t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tse3.apply_transform(_t(src), got).numpy(),
                               np.asarray(se3.apply_transform(src, want)), atol=1e-4)
    np.testing.assert_allclose(tse3.inverse_transform(got).numpy(),
                               np.asarray(se3.inverse_transform(want)), atol=1e-4)


def test_isotropic_transform_error_matches_jax():
    """(RRE, RTE) against JAX's, the clipped cosine at 0 and 180 degrees
    included."""
    from se3et_tpu.core import se3

    rng = np.random.RandomState(5)
    gt = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    est = gt.copy()
    for i in range(3):
        gt[i, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * [1, 1, 1]
        gt[i, :3, :3] *= np.sign(np.linalg.det(gt[i, :3, :3]))
        est[i, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        est[i, :3, :3] *= np.sign(np.linalg.det(est[i, :3, :3]))
    est[4, :3, :3] = np.diag([1.0, -1.0, -1.0])  # 180 degrees
    gt[:, :3, 3] = rng.normal(size=(5, 3))
    est[:, :3, 3] = rng.normal(size=(5, 3))
    want = [np.asarray(x) for x in se3.isotropic_transform_error(gt, est)]
    got = tse3.isotropic_transform_error(_t(gt), _t(est))
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-6)
    np.testing.assert_allclose(got[0].numpy()[3:], [0.0, 180.0], atol=1e-3)


def test_verify_influence_keeps_the_ports_and_drops_the_rest():
    """``verify_influence`` keeps influence stamped for this model in the
    port's layout, and drops, with its stamp, influence of another
    configuration, unstamped influence and JAX's (bf16, H padded)."""
    import dataclasses

    import __graft_entry__ as ge
    from se3et_tpu.data.influence import precompute_influence as jax_influence
    from se3et_tpu_torch.data.influence import (
        influence_signature, precompute_influence, verify_influence,
    )

    _, pipeline, model_cfg = ge._flagship_configs(tiny=True)
    data = ge._example_pair(pipeline, num_points=250, seed=1)
    ours = precompute_influence(dict(data), model_cfg)
    assert np.array_equal(ours["influence_sig"], influence_signature(model_cfg))
    assert sorted(verify_influence(dict(ours), model_cfg)) == sorted(ours)
    other = dataclasses.replace(model_cfg, init_sigma=model_cfg.init_sigma * 2)
    unstamped = {k: v for k, v in ours.items() if k != "influence_sig"}
    jax_made = jax_influence(dict(data), model_cfg)
    for pair, cfg in ((ours, other), (unstamped, model_cfg), (jax_made, model_cfg)):
        with pytest.warns(UserWarning, match="dropping"):
            kept = verify_influence(dict(pair), cfg)
        assert sorted(kept) == sorted(data)


@pytest.mark.parametrize("anchors", [False, True])
def test_masked_group_norm(anchors):
    from se3et_tpu.nn.layers import MaskedGroupNorm as JGN
    from se3et_tpu_torch.nn.layers import MaskedGroupNorm

    rng = np.random.RandomState(4)
    shape = (2, 12, 6, 16) if anchors else (2, 12, 16)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 1
    mask = np.ones((2, 12), bool)
    mask[1, -4:] = False
    scale = (1 + rng.uniform(-0.2, 0.2, 16)).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, 16).astype(np.float32)
    want = np.asarray(JGN(4).apply({"params": {"scale": scale, "bias": bias}}, x, mask))
    gn = MaskedGroupNorm(4, 16)
    gn.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    with torch.no_grad():
        got = gn(_t(x), _t(mask)).numpy()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5, atol=1e-5)


def test_layer_norm():
    from se3et_tpu.nn.layers import LayerNorm as JLN
    from se3et_tpu_torch.nn.layers import LayerNorm

    rng = np.random.RandomState(5)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 16).astype(np.float32)
    want = np.asarray(JLN().apply({"params": {"scale": scale, "bias": bias}}, x))
    ln = LayerNorm(16)
    ln.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    with torch.no_grad():
        np.testing.assert_allclose(ln(_t(x)).numpy(), want, rtol=1e-5, atol=1e-5)


def test_real_sh_matches_numpy_harmonics():
    from se3et_tpu.core import harmonics
    from se3et_tpu_torch.nn.embedding import real_sh

    v = np.random.RandomState(6).normal(size=(4, 9, 3)).astype(np.float32)
    want = harmonics.real_sh([0, 1, 2], v)
    np.testing.assert_allclose(real_sh([0, 1, 2], _t(v)).numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_influence_matches_jax_precompute():
    """The port's fp32 influence == the JAX package's bf16 influence (on its
    unpadded H columns) to bf16 rounding; the port keeps H unpadded."""
    import __graft_entry__ as ge
    from se3et_tpu.data.influence import precompute_influence as jax_influence
    from se3et_tpu_torch.data.influence import precompute_influence

    _, pipeline, model_cfg = ge._flagship_configs(tiny=True)
    data = ge._example_pair(pipeline, num_points=250, seed=1)
    want = jax_influence(dict(data), model_cfg)
    got = precompute_influence(dict(data), model_cfg)
    keys = [k for k in got if k.startswith("influence_") and k != "influence_sig"]
    assert len(keys) == 2 * model_cfg.num_stages - 1
    for key in keys:
        g, w = got[key], np.asarray(want[key], np.float32)
        assert g.dtype == np.float32
        kind, st = key.rsplit("_", 1)
        nbr = data[f"neighbors_{st}" if kind == "influence_same"
                   else f"subsampling_{int(st) - 1}"]
        assert g.shape == nbr.shape + (model_cfg.epn.num_kernel_points,)
        np.testing.assert_allclose(g, w[:, :, :g.shape[2]], rtol=2 ** -7, atol=1e-6)
        assert not w[:, :, g.shape[2]:].any()
