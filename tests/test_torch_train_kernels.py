"""The backward kernels' plain versions (K8-K11) and the Sinkhorn backward of
the PyTorch port against the gradients of their JAX counterparts, on the
CPU at small shapes, from numpy inputs made with a seed:

* K8 ``gather_wf_bwd`` and K9 ``neighbor_max_bwd`` against ``jax.vjp`` of the
  exact gather route of ``se3et_tpu/nn/epn.py`` (the conv's
  ``take_along_axis`` + sentinel ``where`` + influence einsum, and
  ``max_pool_neighbors``), with sentinel neighbours, repeated neighbours and
  forced ties; K8's tile plan against a brute-force listing, its sharing
  per neighbour tensor, a model of its tiles form's summation order against
  the first design's and the plain version, and its form selection;
* K10 ``geometric_embedding_bwd`` against ``jax.vjp`` of
  ``geometric_embedding_trainable`` (Pallas in interpret mode), with tied
  and near-tied angles, and the rounding of its bf16 tc form at the
  training width on a cotangent that leaves near-tied angle maxima out;
* K11 ``rpe_attention_bwd`` against ``jax.vjp`` of
  ``rpe_self_attention_trainable`` (interpret mode), with and without the SH
  term, with masked keys, at N = 128; and the precision plan of its bf16
  tc form (operands rounded to bf16 before each product) against the same
  VJP at the training widths;
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


def _plan_neighbors(rng, b, nq, ns, h, empty=None):
    """_neighbors with all-sentinel rows, a negative (dropped) index, and,
    where ``empty`` is a (lo, hi) range of sources, no slot in it."""
    nbr = _neighbors(rng, b, nq, ns, h)
    nbr[:, -3:] = ns
    nbr[0, 1, 2] = -1
    if empty is not None:
        lo, hi = empty
        inside = (nbr >= lo) & (nbr < hi)
        nbr[inside] = np.where(rng.rand(int(inside.sum())) < 0.5, ns, lo - 1)
    return nbr


@pytest.mark.parametrize("nq,ns,h,tile,empty", [
    (40, 40, 7, 16, None),        # same-level set
    (20, 40, 7, 16, None),        # strided set (fewer queries than sources)
    (33, 77, 5, 8, None),         # ragged: Ns not a multiple of the tile
    (33, 77, 5, 32, None),
    (50, 130, 9, 64, (64, 128)),  # a source range with no slot: empty tiles
    (50, 130, 9, 64, None),
    (30, 25, 64, 4, None),        # H at the plan's limit, tiles of 4 rows
    (12, 5, 3, 64, None),         # one tile, larger than Ns
])
def test_tile_plan_matches_a_brute_force_listing(nq, ns, h, tile, empty):
    """K8's tile plan lists every valid slot exactly once, in its source's
    tile, in ascending (q, h) order within the tile, with its source row
    within the tile; sentinel and negative slots are listed nowhere, and a
    tile no slot reaches is empty."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    rng = np.random.RandomState(nq + ns + tile)
    nbr = _plan_neighbors(rng, 2, nq, ns, h, empty)
    ent, off = wc.tile_plan(torch.from_numpy(nbr), ns, tile)
    ntiles = -(-ns // tile)
    assert ent.dtype == off.dtype == torch.int32
    assert ent.shape == (2, nq * h) and off.shape == (2, ntiles + 1)
    for bi in range(2):
        assert off[bi, 0] == int((nbr[bi] < 0).sum())  # negative slots first, unread
        assert off[bi, ntiles] - off[bi, 0] == int(((nbr[bi] >= 0) & (nbr[bi] < ns)).sum())
        for t in range(ntiles):
            want = [(q, hh, int(nbr[bi, q, hh]) - t * tile)
                    for q in range(nq) for hh in range(h)
                    if t * tile <= nbr[bi, q, hh] < min(ns, (t + 1) * tile)]
            e = ent[bi, off[bi, t]:off[bi, t + 1]].numpy().astype(np.int64)
            got = list(zip((e >> wc.TILE_Q_SHIFT).tolist(),
                           ((e >> wc.TILE_H_SHIFT) & 63).tolist(),
                           (e & (wc.TILE_MAX_ROWS - 1)).tolist()))
            assert got == want, (bi, t)
            if empty is not None and empty[0] <= t * tile and (t + 1) * tile <= empty[1]:
                assert off[bi, t] == off[bi, t + 1]


def test_tile_plan_is_shared_per_neighbour_tensor():
    """The tile plan is built once per (neighbour tensor, Ns) and reused by
    every backward over it, rebuilt after an in-place write, and dropped
    with the tensor."""
    import gc

    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    rng = np.random.RandomState(5)
    nbr = torch.from_numpy(_neighbors(rng, 2, 12, 40, 4))
    first = wc._shared_tile_plan(nbr, 40)
    assert wc._shared_tile_plan(nbr, 40) is first
    assert wc._shared_tile_plan(nbr, 41) is not first
    assert wc._shared_tile_plan(nbr, 40) is first
    other = torch.from_numpy(nbr.numpy().copy())
    assert wc._shared_tile_plan(other, 40) is not first
    nbr[0, 0, 0] = 40  # now a sentinel slot
    rebuilt = wc._shared_tile_plan(nbr, 40)
    assert rebuilt is not first
    for got, want in zip(rebuilt, wc.tile_plan(nbr, 40, wc.GATHER_WF_BWD_TILE)):
        assert torch.equal(got, want)
    count = len(wc._TILE_PLANS)
    del nbr, other
    gc.collect()
    assert len(wc._TILE_PLANS) == count - 2


@pytest.mark.parametrize("nq,ns,h,tile", [(40, 40, 7, 16), (20, 40, 7, 8), (33, 77, 5, 64),
                                         (40, 300, 9, 32)])
def test_tiles_summation_order_gives_the_first_designs_sums(nq, ns, h, tile):
    """A model of K8's tiles form: every slot's value (float32), added to its
    source's sum from 0 in the order the tile plan walks its tile.  It is
    bit for bit the model of the first design, which adds the same values
    per source in the reverse index's order, and equals the plain version
    to float32 rounding (1e-5 of the gradient's scale: sums in another
    order)."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    rng = np.random.RandomState(6)
    b, hp, k, ac = 2, h + 2, 5, 6
    nbr = _plan_neighbors(rng, b, nq, ns, h)
    infl = (rng.rand(b, nq, hp, k) * np.pad((nbr >= 0) & (nbr < ns),
                                            ((0, 0), (0, 0), (0, hp - h)))[..., None])
    dwf = rng.randn(b, nq, k * ac).astype(np.float32)
    dwf_t, nbr_t = torch.from_numpy(dwf), torch.from_numpy(nbr)
    infl_t = torch.from_numpy(infl.astype(np.float32))
    v = torch.einsum("bqhk,bqkc->bqhc", infl_t[:, :, :h], dwf_t.reshape(b, nq, k, ac))
    v = v.reshape(b, nq * h, ac)
    ent, off = wc.tile_plan(nbr_t, ns, tile)
    tiles = torch.zeros((b, ns, ac))
    for bi in range(b):
        for t in range(off.shape[1] - 1):
            for e in ent[bi, off[bi, t]:off[bi, t + 1]].tolist():
                q, hh = e >> wc.TILE_Q_SHIFT, (e >> wc.TILE_H_SHIFT) & 63
                r = e & (wc.TILE_MAX_ROWS - 1)
                tiles[bi, t * tile + r] = tiles[bi, t * tile + r] + v[bi, q * h + hh]
    order, offsets = wc.reverse_index(nbr_t, ns)
    csr = torch.zeros((b, ns, ac))
    for bi in range(b):
        for s in range(ns):
            for slot in order[bi, offsets[bi, s]:offsets[bi, s + 1]].tolist():
                csr[bi, s] = csr[bi, s] + v[bi, slot]
    assert torch.equal(tiles.view(torch.int32), csr.view(torch.int32))
    _close(tiles, wc.gather_wf_bwd_plain(dwf_t, nbr_t, infl_t, ns).numpy(), 1e-5)


@pytest.mark.parametrize("nq,h,k,ac,form", [
    (20000, 24, 15, 192, "tiles"),   # the training convs of se3ete.3dmatch
    (10000, 32, 15, 384, "tiles"),
    (1024, 38, 15, 1536, "tiles"),
    (40, 7, 1, 4, "tiles"),
    (997, 64, 16, 776, "tiles"),
    (997, 65, 15, 192, "first"),     # the plan packs h in 6 bits
    ((1 << 19) - 1, 8, 15, 192, "tiles"),
    (1 << 19, 8, 15, 192, "first"),  # ... and q in 19
    (997, 24, 15, 45, "first"),      # AC % 4 == 0
    (997, 24, 15, 42, "first"),
    (997, 24, 17, 192, "first"),     # neither takes K > 16 (the first design refuses it)
])
def test_gather_wf_bwd_form(nq, h, k, ac, form):
    """K8 takes its tiles form wherever the plan's entries hold the slot
    and AC is a multiple of 4."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    assert wc.gather_wf_bwd_form(nq, h, k, ac) == form


@pytest.mark.parametrize("nq,h,ac,form", [
    (10000, 24, 768, "tiles"),          # the strided skips of se3ete.3dmatch's training
    (2500, 32, 1536, "tiles"),
    (1024, 36, 3072, "tiles"),
    (997, 64, 776, "tiles"),
    (997, 65, 768, "first"),            # the plan packs h in 6 bits
    (997, 24, 4, "tiles"),              # one 16-byte unit a row
    (997, 24, 6, "first"),              # AC % 4 == 0
    ((1 << 19) - 1, 8, 768, "tiles"),
    (1 << 19, 8, 768, "first"),         # ... and q in 19
])
def test_neighbor_max_bwd_form(nq, h, ac, form):
    """K9 takes its tiles form wherever K8's tile plan holds the slot and
    AC is a multiple of 4."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    assert wc.TILES_MAX_NQ == 1 << 19 and wc.TILES_MAX_H == 64
    assert wc.neighbor_max_bwd_form(nq, h, ac) == form


def _k9_args(**change):
    g = torch.Generator().manual_seed(9)
    args = dict(dout=torch.randn((2, 5, 8), generator=g), x=torch.randn((2, 7, 8), generator=g),
                out=torch.randn((2, 5, 8), generator=g),
                nbr=torch.randint(0, 8, (2, 5, 3), generator=g).to(torch.int32))
    args.update(change)
    return args


@pytest.mark.parametrize("change,error", [
    (dict(x=torch.zeros((2, 7, 8), dtype=torch.bfloat16)), TypeError),   # float32 only
    (dict(dout=torch.zeros((2, 5, 8), dtype=torch.float64)), TypeError),
    (dict(out=torch.zeros((2, 5, 8), dtype=torch.bfloat16)), TypeError),
    (dict(nbr=torch.zeros((2, 5, 3), dtype=torch.int64)), TypeError),     # int32 indices
    (dict(out=torch.zeros((2, 5, 9))), ValueError),                       # out of another AC
    (dict(dout=torch.zeros((2, 4, 8))), ValueError),                      # dout of another Nq
    (dict(x=torch.zeros((7, 8))), ValueError),                            # not (B, Ns, AC)
    (dict(nbr=torch.zeros((1, 5, 3), dtype=torch.int32)), ValueError),    # another batch
])
def test_neighbor_max_bwd_refuses_bad_inputs_on_the_cpu(change, error):
    """K9's wrapper checks types and shapes on every device, the CPU (its
    plain version) included, as on the card; good inputs pass."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    assert wc.neighbor_max_bwd(**_k9_args()).shape == (2, 7, 8)
    with pytest.raises(error):
        wc.neighbor_max_bwd(**_k9_args(**change))


@pytest.mark.parametrize("nq,ns,h,ac,case", [
    (20, 40, 7, 8, "integer_ties"),    # strided set, many ties
    (33, 77, 5, 12, "integer_ties"),   # ragged: Ns not a multiple of the tile
    (40, 40, 9, 4, "shadow_zeros"),    # out of +0 and -0 beside sentinel slots
    (12, 5, 3, 8, "shadow_zeros"),     # one tile, larger than Ns
])
def test_neighbor_max_bwd_tiles_model_gives_the_first_designs_bits(nq, ns, h, ac, case):
    """A model of K9's tiles form: the shares from the valid slots' ties and
    the shadow zeros' count (H - valid where out == 0, -0 too), with a tie
    bit per valid slot and channel; then each tile's slots walked in the
    tile plan's order, adding the share where the slot's tie bit is set
    into its source's sum from +0 (float32).  It equals bit for
    bit a model of the first design (each (q, c) counts over its H slots
    with sentinels and negative indices as zeros; each source adds its
    tied slots' shares in the reverse index's order), and the plain
    version to float32 rounding (1e-5 of the gradient's scale: sums in
    another order) on the same set with the negative index as a sentinel,
    which is what the kernels read it as.  Rows with no slot stay +0."""
    from se3et_tpu_torch.ops.geometry import batched_gather_rows
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    rng = np.random.RandomState(ns + h)
    b = 2
    nbr = _plan_neighbors(rng, b, nq, ns, h)
    if case == "integer_ties":
        x = rng.randint(-2, 3, (b, ns, ac)).astype(np.float32)
    else:
        x = -rng.rand(b, ns, ac).astype(np.float32) - 0.5
        x[:, ::3] = 0.0
        x[:, 1::3, ::2] = -0.0
    nbr_t, x_t = torch.from_numpy(nbr), torch.from_numpy(x)
    out = wc.neighbor_max_plain(x_t, nbr_t)
    if case == "shadow_zeros":
        out[:, ::2][out[:, ::2] == 0] = -0.0
    dout = torch.from_numpy(rng.randn(b, nq, ac).astype(np.float32))
    valid = (nbr_t >= 0) & (nbr_t < ns)
    as_sentinel = torch.where(valid, nbr_t, ns)
    g = batched_gather_rows(x_t, as_sentinel)  # (B, Nq, H, AC), 0 where not valid
    tie = g == out[:, :, None, :]
    # the first design: count over every slot, then a CSR walk per source
    count = tie.sum(dim=2)
    share = torch.where(count > 0, dout / count.clamp_min(1).float(), torch.zeros(()))
    order, offsets = wc.reverse_index(nbr_t, ns)
    csr = torch.zeros((b, ns, ac))
    for bi in range(b):
        for s in range(ns):
            for slot in order[bi, offsets[bi, s]:offsets[bi, s + 1]].tolist():
                q = slot // h
                csr[bi, s] = torch.where(x_t[bi, s] == out[bi, q], csr[bi, s] + share[bi, q],
                                         csr[bi, s])
    # the tiles form: the tie bits of the valid slots, their count plus the
    # shadow zeros', then the tile walk on the bits
    bits = tie & valid[..., None]
    count_t = bits.sum(dim=2) + (h - valid.sum(dim=2))[..., None] * (out == 0)
    share_t = torch.where(count_t > 0, dout / count_t.clamp_min(1).float(), torch.zeros(()))
    assert torch.equal(share_t.view(torch.int32), share.view(torch.int32))
    tile = wc.GATHER_WF_BWD_TILE
    ent, off = wc.tile_plan(nbr_t, ns, tile)
    tiles = torch.zeros((b, ns, ac))
    for bi in range(b):
        for t in range(off.shape[1] - 1):
            for e in ent[bi, off[bi, t]:off[bi, t + 1]].tolist():
                q, hh = e >> wc.TILE_Q_SHIFT, (e >> wc.TILE_H_SHIFT) & 63
                s = t * tile + (e & (wc.TILE_MAX_ROWS - 1))
                tiles[bi, s] = torch.where(bits[bi, q, hh], tiles[bi, s] + share_t[bi, q],
                                           tiles[bi, s])
    assert torch.equal(tiles.view(torch.int32), csr.view(torch.int32))
    reached = torch.zeros((b, ns), dtype=torch.bool)
    for bi in range(b):
        reached[bi, nbr_t[bi][valid[bi]].long()] = True
    assert not bool(tiles[~reached].view(torch.int32).any())
    _close(tiles, wc.neighbor_max_bwd_plain(dout, x_t, out, as_sentinel).numpy(), 1e-5)


def _embedding_inputs(seed=3, b=2, n=16, c=32, k=3, ties=True):
    rng = np.random.RandomState(seed)
    points = (rng.rand(b, n, 3) * 1.5).astype(np.float32)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(b * n)]).reshape(b, n, k)
    knn = np.stack([points[bi][idx[bi]] for bi in range(b)]).astype(np.float32)
    if ties:
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
    scale: both round the Chebyshev bases to bf16 before their products,
    but JAX's angle is a polynomial atan2 (error up to 1e-5 rad) and its
    distance the direct form, so the bases of the two round apart here and
    there, and where two of the k angle projections of an element agree to
    within that the two pick different k (on tied and near-tied angles
    their bases are (nearly) the same)."""
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


def test_geometric_embedding_bwd_tc_rounding_matches_jax():
    """The chain K10's tc form runs (its plain version on a bf16 cotangent:
    the forward's bf16 angle projections compared before the bias, the
    bases rounded to bf16 before the products, float32 sums) against the JAX
    VJP of ``geometric_embedding_trainable`` (Pallas interpret), at the
    training width C = 256, N = 32, on inputs without ties: the cotangent is
    0 wherever the two largest angle projections of an element lie within
    1e-3 of the projections' scale (self-pairs, where every angle is 0, and
    near-ties, about 7 % of the elements), so that JAX's polynomial atan2
    cannot move the argmax.  Tolerance 1e-3 of each gradient's scale
    (measured: 1.8e-4 for d_wa, 6.5e-5 for d_wd; float32 bases, the first
    design's chain, give 7.9e-3 for d_wa at C = 64): the bases of the two round to
    bf16 apart where JAX's angle and direct distance differ from the port's
    in the last bits."""
    from se3et_tpu.ops.pallas.embedding import geometric_embedding_trainable
    from se3et_tpu_torch.ops.kernels import embedding as emb_lib

    b, n, c = 2, 32, 256
    points, knn, wd, bd, wa, ba = _embedding_inputs(seed=7, b=b, n=n, c=c, ties=False)
    sigma_d, sigma_a = 0.2, 15.0
    args = [torch.from_numpy(a) for a in (points, knn, wd, bd, wa, ba)]
    _, _, _, ga = emb_lib._folded_projections(args[2], args[4], sigma_a)
    proj = emb_lib._cheb_project(emb_lib._pair_geometry(args[0], args[1], 0, n), 2 / np.pi,
                                 ga, 0.0, torch.bfloat16)  # (B, N, N, k, C)
    top = torch.topk(proj, 2, dim=3).values
    apart = (top[:, :, :, 0] - top[:, :, :, 1] > 1e-3 * float(proj.abs().max())).numpy()
    assert 0.9 < apart.mean() < 0.97
    d_out = jnp.asarray(np.random.RandomState(4).randn(b, n, n, c) * apart, jnp.bfloat16)
    _, vjp = jax.vjp(lambda *w: geometric_embedding_trainable(
        points, knn, *w, sigma_d, sigma_a, 48.0, True), wd, bd, wa, ba)
    want = vjp(d_out)
    dt = torch.from_numpy(np.array(d_out.astype(jnp.float32))).to(torch.bfloat16)
    got = emb_lib.geometric_embedding_bwd_plain(dt, *args, sigma_d, sigma_a)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-3)


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


def _tc_model(q, k, v, qp, emb, masks, qw, pts, d_out, out, lse, scale):
    """K11's tc form as its precision plan states it, on the CPU: the
    scores and P in float32 from the bf16 inputs, dP from dO rounded to
    bf16, dS' = scale * P * (dP - D) rounded to bf16 (dqw takes it
    unrounded), P rounded to bf16; dq = dS' k, dk = dS'^T q, dv = P^T dO,
    dqp = dS' emb and d_emb = dS'^T qp with float32 sums, each rounded to
    bf16 (dqw float32)."""
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    n = q.shape[2]
    s = rpe._scores(q, k, qp, emb, masks, qw, pts, 0, n, scale)
    p = torch.exp(s - lse[..., None]) * masks[:, None, None, :]
    do_b = bf(d_out)
    dpv = torch.einsum("banc,bamc->banm", do_b, v)
    ds = scale * p * (dpv - (d_out * out).sum(-1)[..., None])
    ds_b, p_b = bf(ds), bf(p)
    dqw = None
    if qw is not None:
        rinv, dyzx = rpe._sh_geometry(pts, 0, n)
        dqw = torch.einsum("banm,bdnm->bdan", ds * rinv[:, None], dyzx)
    return (bf(ds_b @ k), bf(ds_b.transpose(-1, -2) @ q), bf(p_b.transpose(-1, -2) @ do_b),
            bf(torch.einsum("banm,bnmd->bnad", ds_b, emb)),
            bf(torch.einsum("banm,bnad->bnmd", ds_b, qp)), dqw)


@pytest.mark.parametrize("ah,with_sh,hc,cc", [
    pytest.param(24, True, 64, 256, id="24-True"),
    pytest.param(4, False, 64, 256, id="4-False"),
    pytest.param(4, True, 64, 256, id="4-True"),
    # head width 32, C = 128: se3ete2's self_eq and plain self layers,
    # se3eti2's self_eq layers
    pytest.param(24, True, 32, 128, id="hw32-24-True"),
    pytest.param(24, False, 32, 128, id="hw32-24-False"),
    pytest.param(4, False, 32, 128, id="hw32-4-False"),
])
def test_rpe_attention_bwd_tc_rounding_matches_jax(ah, with_sh, hc, cc):
    """The precision plan of K11's tc form (P, dS, dO and the embedding
    rounded to bf16 before each product, float32 sums; :func:`_tc_model`)
    against the JAX VJP of ``rpe_self_attention_trainable`` (interpret
    mode, float32 at HIGHEST precision) on the same bf16-valued inputs, at
    the training widths of both families (head width 64 with C = 256, 32
    with C = 128) and N = 128 with masked keys: within 1e-2 of each
    gradient's scale, the tolerance the card's check holds the kernel to
    against the plain version."""
    from se3et_tpu.ops.pallas.rpe_attention import rpe_self_attention_trainable
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    assert rpe.rpe_attention_bwd_form(ah, hc, cc, torch.bfloat16) == "tc"
    rounded = lambda a: np.asarray(  # noqa: E731
        torch.from_numpy(a).to(torch.bfloat16).float().numpy())
    q, k, v, qp, emb, masks, qw, pts = _rpe_inputs(with_sh, seed=15, ah=ah, c=hc, cc=cc)
    q, k, v, qp, emb = (rounded(a) for a in (q, k, v, qp, emb))
    scale = hc ** -0.5
    d_out = np.random.RandomState(16).randn(*q.shape).astype(np.float32)
    diff = (q, k, v, qp, emb) + ((qw,) if with_sh else ())

    def jfn(*a):
        return rpe_self_attention_trainable(a[0], a[1], a[2], a[3], a[4], masks,
                                            a[5] if with_sh else None,
                                            pts if with_sh else None, scale, 64, 128, True)

    _, vjp = jax.vjp(jfn, *diff)
    want = vjp(d_out)
    tq = [torch.from_numpy(a) for a in diff]
    tm = torch.from_numpy(masks)
    tqw, tpts = (tq[5], torch.from_numpy(pts)) if with_sh else (None, None)
    out, lse = rpe.rpe_self_attention_plain(*tq[:5], tm, tqw, tpts, scale=scale, with_lse=True)
    got = _tc_model(*tq[:5], tm, tqw, tpts, torch.from_numpy(d_out), out, lse, scale)
    for name, g, w in zip(("dq", "dk", "dv", "dqp", "demb", "dqw"), got, want):
        if name == "dqw" and not with_sh:
            assert g is None
            continue
        _close(g, w, 1e-2)


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
