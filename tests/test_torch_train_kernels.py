"""The backward kernels' plain versions (K8-K11) and the Sinkhorn backward of
the PyTorch port against the gradients of their JAX counterparts, on the
CPU at small shapes, from numpy inputs made with a seed:

* K8 ``gather_wf_bwd`` and K9 ``neighbor_max_bwd`` against ``jax.vjp`` of the
  exact gather route of ``se3et_tpu/nn/epn.py`` (the conv's
  ``take_along_axis`` + sentinel ``where`` + influence einsum, and
  ``max_pool_neighbors``), with sentinel neighbours, repeated neighbours and
  forced ties;
* K10 ``geometric_embedding_bwd`` against ``jax.vjp`` of
  ``geometric_embedding_trainable`` (Pallas in interpret mode), with tied
  and near-tied angles;
* K11 ``rpe_attention_bwd`` against ``jax.vjp`` of
  ``rpe_self_attention_trainable`` (interpret mode), with and without the SH
  term, with masked keys, at N = 128;
* the Sinkhorn backward (the VJP of the scan form) against ``jax.vjp`` of
  ``_sinkhorn_scan``.

Each tolerance is stated beside its check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _close(got, want, rtol, atol_scale=None):
    """|got - want| <= rtol * max|want| (the gradient's own scale)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = atol_scale if atol_scale is not None else max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _neighbors(rng, b, nq, ns, h, sentinel_share=0.25):
    """(B, Nq, H) int32 rows near the query's index, with sentinels (== ns)
    and repeated indices."""
    q = (np.arange(nq) * ns // nq)[None, :, None]
    nbr = np.clip(q + rng.randint(-6, 7, (b, nq, h)), 0, ns - 1)
    nbr[:, :, 1] = nbr[:, :, 0]  # a repeated neighbour in every row
    nbr[rng.rand(b, nq, h) < sentinel_share] = ns
    return nbr.astype(np.int32)


def _jax_exact_wf(x, nbr, w):
    """The exact gather route of se3et_tpu/nn/epn.py (KPConvInterSO3 without
    window maps): wf[b, n, k, ac] = sum_h w[b, n, h, k] x[b, nbr(n, h), ac]."""
    ns = x.shape[1]
    safe = jnp.clip(nbr, 0, ns - 1)
    g = jnp.take_along_axis(x, safe.reshape(safe.shape[0], -1, 1), axis=1)
    g = g.reshape(nbr.shape + (x.shape[2],))
    g = jnp.where((nbr < ns)[..., None], g, 0.0)
    wf = jnp.einsum("bnhc,bnhk->bnkc", g, w[:, :, :nbr.shape[2]],
                    precision=jax.lax.Precision.HIGHEST)
    return wf.reshape(wf.shape[0], wf.shape[1], -1)


@pytest.mark.parametrize("nq,ns", [(40, 40), (20, 40)])
def test_gather_wf_bwd_matches_jax(nq, ns):
    """K8's plain version (and K1's autograd wrapper) against the JAX VJP of
    the exact gather route; float32, tolerance 1e-5 of the gradient's scale
    (sums in another order)."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    rng = np.random.RandomState(0)
    b, h, hp, k, ac = 2, 7, 9, 5, 12
    x = rng.randn(b, ns, ac).astype(np.float32)
    nbr = _neighbors(rng, b, nq, ns, h)
    infl = (rng.rand(b, nq, hp, k) * np.pad(nbr < ns, ((0, 0), (0, 0), (0, hp - h)))
            [..., None]).astype(np.float32)
    dwf = rng.randn(b, nq, k * ac).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: _jax_exact_wf(xx, nbr, infl), x)
    (want,) = vjp(dwf)

    got = wc.gather_wf_bwd_plain(torch.from_numpy(dwf), torch.from_numpy(nbr),
                                 torch.from_numpy(infl), ns)
    _close(got, want, 1e-5)
    xt = torch.from_numpy(x).requires_grad_(True)
    wc.gather_wf(xt, torch.from_numpy(nbr), torch.from_numpy(infl)).backward(
        torch.from_numpy(dwf))
    _close(xt.grad, want, 1e-5)


def test_gather_wf_refuses_influence_gradients():
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    x = torch.ones(1, 4, 3, requires_grad=True)
    nbr = torch.zeros(1, 2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="influence"):
        wc.gather_wf(x, nbr, torch.ones(1, 2, 2, 3, requires_grad=True))


@pytest.mark.parametrize("case", ["integer_ties", "shadow_zero_max"])
def test_neighbor_max_bwd_matches_jax(case):
    """K9's plain version (and K2's autograd wrapper) against the JAX VJP of
    ``max_pool_neighbors``: ties split evenly, the shadow zeros' shares
    dropped.  Integer-valued features force ties; all-negative rows with
    sentinel neighbours make the shadow zero the max.  float32, tolerance
    1e-6 of the gradient's scale (exact up to the order of the sums)."""
    from se3et_tpu.nn.epn import max_pool_neighbors
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    rng = np.random.RandomState(1)
    b, nq, ns, h, ac = 2, 24, 48, 6, 10
    nbr = _neighbors(rng, b, nq, ns, h, sentinel_share=0.3)
    if case == "integer_ties":
        x = rng.randint(-2, 3, (b, ns, ac)).astype(np.float32)
    else:
        x = -rng.rand(b, ns, ac).astype(np.float32) - 0.5
        x[:, ::5] = 0.0  # real zeros that tie the shadow zero
        nbr[:, ::2, -1] = ns  # every other row has a sentinel
    dout = rng.randn(b, nq, ac).astype(np.float32)
    out, vjp = jax.vjp(lambda xx: max_pool_neighbors(xx, nbr), x)
    (want,) = vjp(dout)

    xt, nt = torch.from_numpy(x), torch.from_numpy(nbr)
    got = wc.neighbor_max_bwd_plain(torch.from_numpy(dout), xt, torch.from_numpy(
        np.array(out)), nt)
    _close(got, want, 1e-6)
    xg = xt.clone().requires_grad_(True)
    np.testing.assert_array_equal(wc.neighbor_max(xg, nt).detach().numpy(), np.asarray(out))
    wc.neighbor_max(xg, nt).backward(torch.from_numpy(dout))
    _close(xg.grad, want, 1e-6)


def test_reverse_index_lists_each_source_slots_in_order():
    """order[offsets[s]:offsets[s+1]] are exactly the flat (q*H + h) slots
    whose neighbour is s, ascending; sentinel slots are listed nowhere."""
    from se3et_tpu_torch.ops.kernels.windowed_conv import reverse_index

    rng = np.random.RandomState(2)
    b, nq, ns, h = 2, 30, 25, 5
    nbr = _neighbors(rng, b, nq, ns, h)
    order, offsets = reverse_index(torch.from_numpy(nbr), ns)
    assert order.dtype == offsets.dtype == torch.int32
    for bi in range(b):
        flat = nbr[bi].reshape(-1)
        for s in range(ns):
            slots = order[bi, offsets[bi, s]:offsets[bi, s + 1]].numpy()
            np.testing.assert_array_equal(slots, np.flatnonzero(flat == s))
        assert offsets[bi, ns] == int((flat < ns).sum())


def test_reverse_index_is_shared_per_neighbour_tensor():
    """The backward kernels' reverse index is built once per neighbour tensor
    and reused by every backward over it, rebuilt after an in-place write,
    and dropped with the tensor."""
    import gc

    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    rng = np.random.RandomState(4)
    nbr = torch.from_numpy(_neighbors(rng, 2, 12, 10, 4))
    first = wc._shared_reverse_index(nbr, 10)
    assert wc._shared_reverse_index(nbr, 10) is first
    other = torch.from_numpy(nbr.numpy().copy())
    assert wc._shared_reverse_index(other, 10) is not first
    nbr[0, 0, 0] = 10  # now a sentinel slot
    rebuilt = wc._shared_reverse_index(nbr, 10)
    assert rebuilt is not first
    for got, want in zip(rebuilt, wc.reverse_index(nbr, 10)):
        assert torch.equal(got, want)
    count = len(wc._REVERSE)
    del nbr, other
    gc.collect()
    assert len(wc._REVERSE) == count - 2


def _embedding_inputs(seed=3, b=2, n=16, c=32, k=3):
    rng = np.random.RandomState(seed)
    points = (rng.rand(b, n, 3) * 1.5).astype(np.float32)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(b * n)]).reshape(b, n, k)
    knn = np.stack([points[bi][idx[bi]] for bi in range(b)]).astype(np.float32)
    knn[:, ::3, 1] = knn[:, ::3, 0]  # tied angles: a repeated neighbour
    knn[:, 1::3, 2] = knn[:, 1::3, 0] + 1e-4  # near-tied angles
    bound = 1.0 / np.sqrt(c)
    wd, wa = (rng.uniform(-bound, bound, (c, c)).astype(np.float32) for _ in range(2))
    bd, ba = (rng.uniform(-bound, bound, (c,)).astype(np.float32) for _ in range(2))
    return points, knn, wd, bd, wa, ba


def test_geometric_embedding_bwd_matches_jax():
    """K10's plain version (and K3's autograd wrapper) against the JAX VJP of
    ``geometric_embedding_trainable`` (Pallas interpret, bf16 output, the
    backward's basis products in bf16).  Tolerance 2e-2 of each gradient's
    scale: the JAX kernel rounds the Chebyshev bases and the cotangent to
    bf16 before its products, the port keeps the bases in float32; on
    (near-)tied angles the two may pick different k, whose bases are
    (nearly) the same."""
    from se3et_tpu.ops.pallas.embedding import geometric_embedding_trainable
    from se3et_tpu_torch.ops.kernels import embedding as emb_lib

    points, knn, wd, bd, wa, ba = _embedding_inputs()
    sigma_d, sigma_a = 0.2, 15.0
    rng = np.random.RandomState(4)
    d_out = jnp.asarray(rng.randn(2, 16, 16, 32), jnp.bfloat16)
    _, vjp = jax.vjp(lambda *w: geometric_embedding_trainable(
        points, knn, *w, sigma_d, sigma_a, 48.0, True), wd, bd, wa, ba)
    want = vjp(d_out)
    dt = torch.from_numpy(np.array(d_out.astype(jnp.float32))).to(torch.bfloat16)
    args = [torch.from_numpy(a) for a in (points, knn, wd, bd, wa, ba)]
    got = emb_lib.geometric_embedding_bwd_plain(dt, *args, sigma_d, sigma_a)
    for g, w in zip(got, want):
        _close(g, w, 2e-2)
    params = [a.clone().requires_grad_(True) for a in args[2:]]
    out = emb_lib.geometric_embedding(args[0], args[1], *params, sigma_d, sigma_a)
    assert out.dtype == torch.bfloat16
    out.backward(dt)
    for p, g in zip(params, got):
        np.testing.assert_array_equal(p.grad.numpy(), g.numpy())


def _rpe_inputs(with_sh, seed=5, b=2, ah=4, n=128, c=16, cc=32):
    rng = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    q, k, v = f(b, ah, n, c), f(b, ah, n, c), f(b, ah, n, c)
    qp = f(b, n, ah, cc, sc=cc ** -0.5)
    emb = f(b, n, n, cc)
    masks = np.ones((b, n), bool)
    masks[1, -19:] = False
    masks[0, 5] = False
    qw = f(b, 3, ah, n, sc=0.3) if with_sh else None
    pts = np.concatenate([rng.rand(b, 3, n) * 2.0, np.zeros((b, 1, n))], 1).astype(
        np.float32) if with_sh else None
    return q, k, v, qp, emb, masks, qw, pts


@pytest.mark.parametrize("with_sh", [False, True])
def test_rpe_attention_bwd_matches_jax(with_sh):
    """K11's plain version with its contractions (and K5's autograd wrapper)
    against the JAX VJP of ``rpe_self_attention_trainable`` (interpret mode,
    block 64 x 128) at N = 128 with masked keys, float32.  Tolerance 1e-4 of
    each gradient's scale: float32 sums in another order, the row statistics
    of an online softmax against the port's direct one."""
    from se3et_tpu.ops.pallas.rpe_attention import rpe_self_attention_trainable
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    q, k, v, qp, emb, masks, qw, pts = _rpe_inputs(with_sh)
    scale = 0.25
    rng = np.random.RandomState(6)
    d_out = rng.randn(*q.shape).astype(np.float32)
    diff = (q, k, v, qp, emb) + ((qw,) if with_sh else ())

    def jfn(*a):
        qw_ = a[5] if with_sh else None
        return rpe_self_attention_trainable(a[0], a[1], a[2], a[3], a[4], masks, qw_,
                                            pts if with_sh else None, scale, 64, 128, True)

    want_out, vjp = jax.vjp(jfn, *diff)
    want = vjp(d_out)
    tq = [torch.from_numpy(a) for a in diff]
    tm = torch.from_numpy(masks)
    tpts = torch.from_numpy(pts) if with_sh else None
    tqw = tq[5] if with_sh else None
    out, lse = rpe.rpe_self_attention_plain(*tq[:5], tm, tqw, tpts, scale=scale, with_lse=True)
    _close(out, want_out, 1e-5)
    got = rpe.rpe_attention_bwd_plain(*tq[:5], tm, tqw, tpts, torch.from_numpy(d_out), out,
                                      lse, scale=scale)
    names = ("dq", "dk", "dv", "dqp", "demb", "dqw")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, 1e-4)
    if not with_sh:
        assert got[5] is None
    leaves = [t.clone().requires_grad_(True) for t in tq]
    o = rpe.rpe_self_attention(*leaves[:5], tm, leaves[5] if with_sh else None, tpts,
                               scale=scale)
    o.backward(torch.from_numpy(d_out))
    for t, g in zip(leaves, got):
        np.testing.assert_allclose(t.grad.numpy(), g.numpy(), rtol=0, atol=0)


def test_sinkhorn_backward_matches_jax_scan():
    """The Sinkhorn's gradient (K4 forward, VJP of the scan form) against
    ``jax.vjp`` of the JAX ``_sinkhorn_scan`` on masked patches, 20
    iterations, float32; tolerance 1e-4 of the gradient's scale."""
    from se3et_tpu.nn.matching import _sinkhorn_scan
    from se3et_tpu_torch.ops.kernels import selfcheck, sinkhorn

    padded, mu, nu, _ = selfcheck.sinkhorn_inputs(6, 9, 11, "cpu")
    rng = np.random.RandomState(7)
    g = rng.randn(*padded.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p: _sinkhorn_scan(p, mu.numpy(), nu.numpy(), 20),
                     padded.numpy())
    (want,) = vjp(g)
    p = padded.clone().requires_grad_(True)
    sinkhorn.sinkhorn(p, mu, nu, 20).backward(torch.from_numpy(g))
    _close(p.grad, want, 1e-4)
