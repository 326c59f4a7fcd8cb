"""The flash attention route of the PyTorch port (K5-K7 and the modules
that call them) against the JAX package, on the CPU.

The same float32 numpy arrays, made from a seed, go to both packages; the
Pallas kernels run in interpret mode, as tests/test_attention.py runs
them, and on the CPU each port wrapper takes its plain version.  Only valid
query rows are compared: padded rows carry no meaning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3et_tpu.nn import attention as jattn
from se3et_tpu.ops.pallas import eq_attention as jeq
from se3et_tpu.ops.pallas import rpe_attention as jrpe
from se3et_tpu_torch.convert import flax_to_state_dict
from se3et_tpu_torch.ops.kernels import eq_attention as eq_k
from se3et_tpu_torch.ops.kernels import rpe_attention as rpe_k

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rpe_inputs(seed, b=2, ah=6, n=128, c=16, cc=32):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    pts = rng.uniform(0, 1, size=(b, n, 3)).astype(np.float32)
    p4 = np.concatenate([pts, np.zeros((b, n, 1), np.float32)], -1).swapaxes(1, 2).copy()
    masks = np.stack([np.arange(n) < n - 9, np.arange(n) < n - 3])[:b]
    return dict(q=f(b, ah, n, c), k=f(b, ah, n, c), v=f(b, ah, n, c),
                qp=f(b, n, ah, cc, sc=0.3), emb=f(b, n, n, cc, sc=0.5), km=masks,
                qw=f(b, 3, ah, n, sc=0.3), points=p4)


@pytest.mark.parametrize("with_sh", [False, True])
def test_rpe_self_attention_plain_matches_pallas(with_sh):
    """K5's plain version == the TPU kernel (interpret mode) on masked keys,
    with and without the SH term.  rtol 2e-3, atol 2e-4: the TPU kernel
    forms r^2 by the |p|^2 - 2 p.q + |q|^2 expansion, which cancels
    differently from the coordinate differences used here."""
    x = _rpe_inputs(0)
    qw = x["qw"] if with_sh else None
    pts = x["points"] if with_sh else None
    want = np.asarray(jrpe.rpe_self_attention(
        *(jnp.asarray(x[k]) for k in ("q", "k", "v", "qp", "emb", "km")),
        None if qw is None else jnp.asarray(qw), None if pts is None else jnp.asarray(pts),
        scale=0.25, block_n=64, block_m=128, interpret=True))
    got = rpe_k.rpe_self_attention(
        *(_t(x[k]) for k in ("q", "k", "v", "qp", "emb", "km")),
        None if qw is None else _t(qw), None if pts is None else _t(pts), scale=0.25)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)


def test_fold_equivariant_query_matches_jax():
    """The Wigner-D fold of the SH query equals JAX's, float32 to 1e-6."""
    rng = np.random.RandomState(1)
    qe = rng.normal(size=(2, 6, 2, 8, 4)).astype(np.float32)
    wd1 = rng.normal(size=(6, 3, 3)).astype(np.float32)
    want = np.asarray(jrpe.fold_equivariant_query(jnp.asarray(qe), wd1))
    got = rpe_k.fold_equivariant_query(_t(qe), _t(wd1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _eq_inputs(seed, a=6, e=6, h=2, n=24, m=28, c=16):
    rng = np.random.RandomState(seed)
    return dict(
        q=rng.normal(size=(a, h, n, c)).astype(np.float32),
        k=rng.normal(size=(e, h, m, c)).astype(np.float32),
        v=rng.normal(size=(e, h, m, c)).astype(np.float32),
        qm=np.arange(n) < n - 3, km=np.arange(m) < m - 5,
        sq=rng.uniform(0.5, 1.5, size=(a, h)).astype(np.float32),
        sk=rng.uniform(0.5, 1.5, size=(e, h)).astype(np.float32),
        w=rng.uniform(0, 1, size=(a, e)).astype(np.float32),
    )


def _close(got, want, rtol):
    """rtol relative, atol rtol x the largest magnitude (values near 0)."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("positive,sup", [
    ("sq", False), ("sq", True), (None, False), ("abs", False), ("relu", False),
    ("sigmoid", False), ("leakyrelu", False), ("softplus", False), ("minus", False),
])
def test_eq_attention_stats_plain_matches_pallas(positive, sup):
    """K6's plain version == the TPU kernel (interpret mode) for every
    positive() mode, with and without the supervision max, at N = 24 and
    M = 28 (no multiple of any block).  rtol 1e-5 (float32 sums in another
    order), atol 1e-5 of the output scale."""
    x = _eq_inputs(2)
    args = [jnp.asarray(x[k]) for k in ("q", "k", "qm", "km")]
    if sup:
        want = jeq.eq_attention_stats(*args, jnp.asarray(x["sq"])[..., None],
                                      jnp.asarray(x["sk"])[..., None], positive=positive,
                                      with_sup=True, interpret=True)
        got = eq_k.eq_attention_stats(*(_t(x[k]) for k in ("q", "k", "qm", "km")),
                                      _t(x["sq"]), _t(x["sk"]), positive=positive)
    else:
        want = jeq.eq_attention_stats(*args, positive=positive, interpret=True)
        got = eq_k.eq_attention_stats(*(_t(x[k]) for k in ("q", "k", "qm", "km")),
                                      positive=positive)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_eq_attention_apply_plain_matches_pallas():
    """K7's plain version == the TPU kernel (interpret mode) with the same
    row statistics and weights; rtol 1e-5, atol 1e-5 of the output scale."""
    x = _eq_inputs(3)
    rowmax, rowsum, _ = jeq.eq_attention_stats(
        *(jnp.asarray(x[k]) for k in ("q", "k", "qm", "km")), interpret=True)
    want = jeq.eq_attention_apply(
        *(jnp.asarray(x[k]) for k in ("q", "k", "v", "w")), rowmax, rowsum,
        jnp.asarray(x["km"]), interpret=True)
    got = eq_k.eq_attention_apply(*(_t(x[k]) for k in ("q", "k", "v", "w")),
                                  _t(rowmax), _t(rowsum), _t(x["km"]))
    _close(got, want, 1e-5)


def _port_module(cls, params, *args, **kwargs):
    mod = cls(*args, **kwargs)
    mod.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return mod.eval()


@pytest.mark.parametrize("equivariant", [False, True])
def test_rpe_attention_flash_route_matches_jax(equivariant):
    """RPEMultiHeadAttention's flash route (K5 plain on the CPU) == JAX's
    ``use_flash=True`` route (Pallas interpret) at n = 128 with masked keys;
    rtol 2e-3, atol 2e-4 as for K5 (the r^2 expansion on the JAX side)."""
    from se3et_tpu.nn.embedding import GeometricStructureEmbedding
    from se3et_tpu_torch.nn.attention import RPEMultiHeadAttention

    rng = np.random.RandomState(7)
    b, n, c, a, h = 1, 128, 16, 6, 2
    emb_mod = GeometricStructureEmbedding(
        hidden_dim=c, sigma_d=0.2, sigma_a=15.0, angle_k=3,
        kanchor=a if equivariant else 1, n_level_equiv=2 if equivariant else 0)
    points = jnp.asarray(rng.uniform(0, 1, size=(b, n, 3)).astype(np.float32))
    masks = jnp.asarray(np.arange(n) < n - 9)[None]
    emb, _ = emb_mod.apply(emb_mod.init(jax.random.PRNGKey(0), points, masks), points, masks)
    kw = dict(equivariant=equivariant, d_equiv_embed=4 if equivariant else 0,
              kanchor=a if equivariant else 0)
    attn = jattn.RPEMultiHeadAttention(d_model=c, num_heads=h, **kw)
    x = jnp.asarray(rng.normal(size=(b, a, n, c) if equivariant else (b, n, c))
                    .astype(np.float32))
    params = attn.init(jax.random.PRNGKey(1), x, x, x, emb, key_masks=masks,
                       points=points, use_flash=True)
    want, _ = attn.apply(params, x, x, x, emb, key_masks=masks, points=points,
                         use_flash=True)
    port = _port_module(RPEMultiHeadAttention, params, c, h, **kw)
    with torch.no_grad():
        got, _ = port(_t(x), _t(x), _t(x), _t(emb), key_masks=_t(masks),
                      points=_t(points), use_flash=True)
    valid = np.asarray(masks)[0]
    np.testing.assert_allclose(got.numpy()[..., valid, :],
                               np.asarray(want)[..., valid, :], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("mode", ["a_soft", "r_soft"])
def test_eq_attention_flash_route_matches_jax(mode):
    """MultiHeadAttentionEQ's flash route (K6 + K7 plain on the CPU) == JAX's
    ``use_flash=True`` route: outputs on valid rows and the anchor/rotation
    weights.  rtol 1e-5, atol 1e-5 of the output scale (float32 sums in
    another order)."""
    from se3et_tpu_torch.nn.attention import MultiHeadAttentionEQ

    rng = np.random.RandomState(3)
    b, a, n, m, c = 1, 6, 24, 28, 16
    attn = jattn.MultiHeadAttentionEQ(d_model=c, num_heads=2, attn_mode=mode, kanchor=a)
    q, k, v = (jnp.asarray(rng.normal(size=(b, a, s, c)).astype(np.float32))
               for s in (n, m, m))
    key_masks = jnp.asarray((np.arange(m) < m - 5)[None])
    q_masks = jnp.asarray((np.arange(n) < n - 3)[None])
    params = attn.init(jax.random.PRNGKey(0), q, k, v, key_masks, q_masks)
    want, aux_want = attn.apply(params, q, k, v, key_masks, q_masks, use_flash=True)
    port = _port_module(MultiHeadAttentionEQ, params, c, 2, mode, kanchor=a)
    with torch.no_grad():
        got, aux = port(_t(q), _t(k), _t(v), key_masks=_t(key_masks), q_masks=_t(q_masks),
                        use_flash=True)
    vr = np.asarray(q_masks[0])
    _close(got[:, :, vr], np.asarray(want)[:, :, vr], 1e-5)
    _close(aux["attn_w"], aux_want["attn_w"], 1e-5)


def test_transformer_flash_matches_jax():
    """GeometricTransformer(fused_attention=True): stacked K5 self layers
    and K6 + K7 EQ cross layers == the JAX transformer's flash route at
    n = 128 with SE3ET-E blocks; tolerance 1e-3 x the output scale (the
    K5 r^2 difference, carried through six layers)."""
    from se3et_tpu.nn.transformer import GeometricTransformer as JGT
    from se3et_tpu_torch.nn.transformer import GeometricTransformer

    rng = np.random.RandomState(11)
    b, n, cin, c, a = 1, 128, 24, 16, 6
    blocks = ("self_eq", "cross_a_soft", "self_eq", "cross_r_soft", "self", "cross")
    kw = dict(input_dim=cin, output_dim=c, hidden_dim=c, num_heads=2, blocks=blocks,
              sigma_d=0.2, sigma_a=15.0, angle_k=3, na=a, n_level_equiv=2)
    jmodel = JGT(**kw)
    ref_points = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    src_points = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    ref_feats = rng.randn(b, n, a, cin).astype(np.float32)
    src_feats = rng.randn(b, n, a, cin).astype(np.float32)
    ref_masks = (np.arange(n) < n - 5)[None]
    src_masks = (np.arange(n) < n - 9)[None]
    inputs = (ref_points, src_points, ref_feats, src_feats, ref_masks, src_masks)
    jin = [jnp.asarray(t) for t in inputs]
    params = jmodel.init(jax.random.PRNGKey(0), *jin)
    want = jmodel.apply(params, *jin, fused_attention=True)
    port = _port_module(GeometricTransformer, params, **kw)
    with torch.no_grad():
        got = port(*(_t(t) for t in inputs), fused_attention=True)
    for i, valid in ((0, ref_masks[0]), (1, src_masks[0])):
        w = np.asarray(want[i])[:, valid]
        scale = np.abs(w).max()
        np.testing.assert_allclose(got[i].numpy()[:, valid], w, rtol=0, atol=1e-3 * scale,
                                   err_msg=f"output {i}")
