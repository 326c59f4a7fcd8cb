"""Plain versions of the PyTorch port's kernels (K1-K4) against their JAX
and Pallas counterparts, on the CPU.

The same numpy arrays, made from a seed, go to both packages; the Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Comparisons cover valid rows only (padded rows carry no meaning).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3et_tpu.data import pipeline as pipe
from se3et_tpu_torch.ops.kernels import embedding as emb_k
from se3et_tpu_torch.ops.kernels import selfcheck
from se3et_tpu_torch.ops.kernels import sinkhorn as sk_k
from se3et_tpu_torch.ops.kernels import windowed_conv as wc_k

torch.set_num_threads(1)


def _neighbors(rng, b, nq, ns, h):
    """Random neighbour rows with sentinel (== ns) entries, incl. all-sentinel rows."""
    nbr = rng.randint(0, ns, size=(b, nq, h)).astype(np.int32)
    nbr[rng.rand(b, nq, h) < 0.3] = ns
    nbr[:, -3:] = ns
    return nbr


@pytest.mark.parametrize("cin", [4, 256])
def test_conv_gather_wf_matches_jax_exact_route(cin):
    """K1 plain + the expanded (cin < 256) or factored (cin >= 256) weight
    contraction == KPConvInterSO3's exact gather route (no window maps),
    fp32, rtol/atol 1e-5 relative to the output scale."""
    from se3et_tpu.nn.epn import EPNConfig as JEPN
    from se3et_tpu.nn.epn import KPConvInterSO3 as JConv
    from se3et_tpu_torch.nn.epn import EPNConfig, KPConvInterSO3

    rng = np.random.RandomState(0)
    b, ns, nq, h, k, cout = 2, 40, 24, 7, 15, 8
    x = rng.normal(size=(b, ns, 6, cin)).astype(np.float32)
    nbr = _neighbors(rng, b, nq, ns, h)
    infl = (rng.rand(b, nq, h, k) * (nbr < ns)[..., None]).astype(np.float32)
    pts = np.zeros((b, ns, 3), np.float32)

    jconv = JConv(cin, cout, radius=0.25, sigma=0.2, config=JEPN())
    params = jconv.init(jax.random.PRNGKey(0), x, pts[:, :nq], pts, nbr, influence=infl)
    weights = rng.uniform(-0.1, 0.1, size=params["params"]["weights"].shape).astype(np.float32)
    want = np.asarray(jconv.apply({"params": {"weights": weights}}, x, pts[:, :nq], pts,
                                  nbr, influence=infl))

    conv = KPConvInterSO3(cin, cout, 0.25, EPNConfig())
    conv.weights.data = torch.from_numpy(weights)
    with torch.no_grad():
        got = conv(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(infl))
    got = got.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_gather_wf_plain_matches_windowed_kernel():
    """K1 plain == the TPU kernel windowed_gather_wf (interpret mode) on
    window maps that cover every source segment (no neighbour drops)."""
    from se3et_tpu.ops.pallas import windowed_conv as wc

    rng = np.random.RandomState(1)
    b, ns, nq, h, k, ac = 2, 96, 70, 9, 15, 24
    x = rng.normal(size=(b, ns, ac)).astype(np.float32)
    nbr = _neighbors(rng, b, nq, ns, h)
    infl = (rng.rand(b, nq, h, k) * (nbr < ns)[..., None]).astype(np.float32)
    nseg = (ns + pipe.WINDOW_SSEG - 1) // pipe.WINDOW_SSEG
    maps = [pipe.build_window_maps(nbr[i], ns, nseg) for i in range(b)]
    seg_idx = jnp.asarray(np.stack([m[0] for m in maps]))
    local = jnp.asarray(np.stack([m[1] for m in maps]))
    windows = wc.segment_window_gather(jnp.asarray(x), seg_idx)
    want = np.asarray(wc.windowed_gather_wf(local, jnp.asarray(infl), windows,
                                            interpret=True))
    got = wc_k.gather_wf(torch.from_numpy(x), torch.from_numpy(nbr),
                         torch.from_numpy(infl)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neighbor_max_plain_matches_jax_exactly(dtype):
    """K2 plain == max_pool_neighbors bit for bit; sentinel rows count as
    zero rows, all-sentinel rows give zeros."""
    from se3et_tpu.nn.epn import max_pool_neighbors

    rng = np.random.RandomState(2)
    b, ns, nq, h = 2, 50, 30, 6
    x = rng.normal(size=(b, ns, 6, 5)).astype(np.float32)
    nbr = _neighbors(rng, b, nq, ns, h)
    want = np.asarray(max_pool_neighbors(jnp.asarray(x, dtype), jnp.asarray(nbr)),
                      np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(b, ns, 30)
    got = wc_k.neighbor_max(xt, torch.from_numpy(nbr)).float().reshape(b, nq, 6, 5).numpy()
    np.testing.assert_array_equal(got, want)


def _embedding_inputs(n=32, c=64, seed=3):
    rng = np.random.RandomState(seed)
    b = 2
    pts = rng.uniform(-1.0, 1.0, size=(b, n, 3)).astype(np.float32)
    masks = np.ones((b, n), bool)
    masks[1, -5:] = False
    pts[1, -5:] = 0.0  # zero-padded rows, as the pipeline emits
    params = {
        "proj_d_kernel": rng.uniform(-0.125, 0.125, (c, c)).astype(np.float32),
        "proj_d_bias": rng.uniform(-0.125, 0.125, (c,)).astype(np.float32),
        "proj_a_kernel": rng.uniform(-0.125, 0.125, (c, c)).astype(np.float32),
        "proj_a_bias": rng.uniform(-0.125, 0.125, (c,)).astype(np.float32),
    }
    return pts, masks, params


def _valid_block(a, masks):
    return [a[i][masks[i]][:, masks[i]] for i in range(a.shape[0])]


def test_embedding_matches_jax_xla_route():
    """K3 plain (Chebyshev fold, float32 out), through the port's
    GeometricStructureEmbedding, == the JAX XLA sinusoid route in float32:
    |diff| <= 1e-4 * max|emb| (Chebyshev fit error <= 1e-5 per feature)."""
    from se3et_tpu.nn.embedding import GeometricStructureEmbedding as JEmb
    from se3et_tpu_torch.nn.embedding import GeometricStructureEmbedding

    pts, masks, params = _embedding_inputs()
    c = params["proj_d_kernel"].shape[0]
    jemb = JEmb(c, 0.2, 15.0, 3)
    want, _ = jemb.apply({"params": params}, jnp.asarray(pts), jnp.asarray(masks),
                         fused=False)
    want = np.asarray(want)

    temb = GeometricStructureEmbedding(c, 0.2, 15.0, 3)
    temb.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got, _ = temb(torch.from_numpy(pts), torch.from_numpy(masks), fused=True)
    assert got.dtype == torch.float32
    tol = 1e-4 * np.abs(want).max()
    for g, w in zip(_valid_block(got.numpy(), masks), _valid_block(want, masks)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_embedding_plain_matches_pallas_kernel():
    """K3 plain (bf16 out) == geometric_embedding_pallas in interpret mode:
    both round the bases and G to bf16 and sum in float32, so a row lands
    at most one bf16 ulp apart where the TPU kernel's polynomial atan2 and
    direct distance (the port: exact atan2, the expanded distance) or the
    order of the float32 sums move it across a rounding boundary:
    |diff| <= 5e-3 * max|emb| (one ulp at the scale, < 2^-7), and under 2 %
    of the valid elements differ at all."""
    from se3et_tpu.nn.embedding import GeometricStructureEmbedding as JEmb
    from se3et_tpu.ops.pallas.embedding import geometric_embedding_pallas

    pts, masks, params = _embedding_inputs(n=16, seed=4)
    c = params["proj_d_kernel"].shape[0]
    _, _, knn = JEmb(c, 0.2, 15.0, 3).apply(
        {"params": params}, jnp.asarray(pts), jnp.asarray(masks), tables_only=True)
    knn = np.array(knn)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(geometric_embedding_pallas(
        jnp.asarray(pts), jnp.asarray(knn), p["proj_d_kernel"], p["proj_d_bias"],
        p["proj_a_kernel"], p["proj_a_bias"], sigma_d=0.2, sigma_a=15.0,
        interpret=True), np.float32)
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    got = emb_k.geometric_embedding(
        torch.from_numpy(pts), torch.from_numpy(knn), t["proj_d_kernel"],
        t["proj_d_bias"], t["proj_a_kernel"], t["proj_a_bias"], 0.2, 15.0,
        out_dtype=torch.bfloat16).float().numpy()
    tol = 5e-3 * np.abs(want).max()
    differ = total = 0
    for g, w in zip(_valid_block(got, masks), _valid_block(want, masks)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        differ += int((g != w).sum())
        total += g.size
    assert differ < 0.02 * total


@pytest.mark.parametrize("reference", ["pallas", "scan"])
def test_sinkhorn_plain_matches_jax(reference):
    """K4 plain == sinkhorn_pallas (interpret) and the lax.scan route on
    every valid entry, to 1e-4, with fully masked rows and columns (C8)."""
    from se3et_tpu.nn.matching import _sinkhorn_scan
    from se3et_tpu.ops.pallas.sinkhorn import sinkhorn_pallas

    padded, log_mu, log_nu, valid = selfcheck.sinkhorn_inputs(6, 17, 13, "cpu", seed=5)
    iters = 30
    args = [jnp.asarray(a.numpy()) for a in (padded, log_mu, log_nu)]
    if reference == "pallas":
        want = sinkhorn_pallas(*args, num_iterations=iters, tile=2, interpret=True)
    else:
        want = _sinkhorn_scan(*args, iters)
    want = np.asarray(want)
    got = sk_k.sinkhorn(padded, log_mu, log_nu, iters).numpy()
    valid = valid.numpy()
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4, atol=1e-4)
