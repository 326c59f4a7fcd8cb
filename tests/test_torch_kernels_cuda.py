"""The port's CUDA kernels (K1-K7, the fused serving convs K12-K14, the
training backwards K8-K11, the device influence K15 and the fused-embedding
attention K16) against their plain versions on the card,
at the serving and training shapes of se3ete.3dmatch, at ragged shapes (N
not a multiple of any block) and at the tiny float32 widths of the
card-vs-CPU check.
Skipped where no CUDA device is present; run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from se3et_tpu_torch.ops.kernels import selfcheck

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_ok(res):
    assert res.ok, (res.name, res.shape, res.max_abs_err, res.tol)


@pytest.mark.parametrize("nq,ns,h,ac", [
    (20000, 20000, 24, 192),   # stage-0 bottleneck conv
    (10000, 20000, 24, 192),   # stage-1 strided conv
    (2500, 2500, 36, 768),     # stage-2 convs (served by K1 on the fused route)
    (1024, 2500, 36, 768),     # s2 -> s3 strided conv
    (1024, 1024, 38, 1536),    # stage-3 conv (factored weights)
    (997, 2000, 16, 192),      # the tensor-core form's HS edges: 1, 2, 3, 4
    (997, 2000, 17, 192),
    (997, 2000, 48, 192),
    (997, 2000, 64, 192),
    (997, 2000, 65, 192),      # H > 64: the first design in bf16 too
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_wf_kernel(cuda, nq, ns, h, ac, dtype):
    g = torch.Generator().manual_seed(0)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    _assert_ok(selfcheck.check_gather_wf(nbr, ns, ac, dtype=dtype, reps=1))


@pytest.mark.parametrize("nq,ns,h,ac,k", [
    (1003, 2000, 36, 768, 15),   # ragged Nq: a warp's items end inside a row
    (250, 997, 36, 192, 1),      # K 1 and 16
    (250, 997, 36, 192, 16),
    (250, 997, 24, 8, 15),       # AC 8: one 16-byte unit of a 32-channel chunk
    (250, 997, 36, 776, 15),     # AC not a multiple of the 32-channel chunk
    (7, 50, 5, 40, 3),           # fewer items than one warp's share
])
def test_gather_wf_kernel_edges(cuda, nq, ns, h, ac, k):
    """K1 in bf16 (the tensor-core form) at ragged widths, with about a
    quarter sentinel neighbours and the last 3 query rows all sentinels."""
    nbr = _conv_neighbors(cuda, nq, ns, h, 14)
    _assert_ok(selfcheck.check_gather_wf(nbr, ns, ac, k=k, dtype=torch.bfloat16, reps=1))


def test_gather_wf_reads_padded_influence_in_place(cuda):
    """K1 in bf16 reads the first H of H' > H influence columns as they lie:
    equal to the plain version on the same tensor, bit for bit to itself on
    the unpadded copy, and exactly zero on all-sentinel rows."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(21)
    nq, ns, h = 1003, 2000, 36
    nbr = _conv_neighbors(cuda, nq, ns, h, 21)
    x = torch.randn((2, ns, 768), generator=g).to(cuda, torch.bfloat16)
    infl = torch.rand((2, nq, h + 12, 15), generator=g).to(cuda, torch.bfloat16)
    infl[:, :, :h] *= (nbr < ns)[..., None]
    got = wc.gather_wf(x, nbr, infl)
    want = wc.gather_wf_plain(x, nbr, infl)
    assert float((got - want).float().abs().max()) <= 1e-2 * float(want.float().abs().max())
    assert torch.equal(got, wc.gather_wf(x, nbr, infl[:, :, :h].contiguous()))
    assert not bool(got[:, -3:].any())


@pytest.mark.parametrize("h,dtype", [(24, torch.float32), (38, torch.float32),
                                     (65, torch.bfloat16)])
def test_gather_wf_first_design_is_bit_identical(cuda, h, dtype):
    """K1's first design (asked for by name: the float32 shapes here take
    the rows form) equals bit for bit the wf of K14's first design, which
    these shapes take and which carries that design's arithmetic unchanged,
    with the influence read in place (H' > H).  K14's tc form equals K1's
    tc form instead (test_gather_wf_max_tc_equals_k1_and_k2)."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    assert wc.gather_wf_max_form(h, dtype, 192, 8) == "first"
    g = torch.Generator().manual_seed(22)
    nq, ns = 1003, 2000
    nbr = _conv_neighbors(cuda, nq, ns, h, 22)
    x = torch.randn((2, ns, 192), generator=g).to(cuda, dtype)
    infl = torch.rand((2, nq, h + 4, 15), generator=g).to(cuda, dtype)
    infl[:, :, :h] *= (nbr < ns)[..., None]
    x2 = torch.randn((2, ns, 8), generator=g).to(cuda, dtype)
    want, _ = wc.gather_wf_max(x, nbr, infl, x2)
    assert torch.equal(wc._gather_wf_forward(x, nbr, infl, form="first"), want)


@pytest.fixture(scope="module")
def pair0():
    """Pair 0's pyramid as chip_smoke.py builds it (synthetic se3ete.3dmatch
    pair at point_limit 20000, host pipeline, exact neighbours)."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    return synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)


# the float32 K1 (and K8) training shapes: (neighbour set, source stage, A*C)
K1_TRAIN_SHAPES = (("neighbors_0", 0, 192), ("subsampling_0", 0, 192), ("neighbors_1", 1, 384),
                   ("subsampling_1", 1, 384), ("neighbors_2", 2, 768),
                   ("subsampling_2", 2, 768), ("neighbors_3", 3, 1536))


@pytest.mark.parametrize("key,src,ac", K1_TRAIN_SHAPES)
def test_gather_wf_rows_is_bit_identical(cuda, pair0, key, src, ac):
    """K1 in float32 takes the rows form at the seven training convs on pair
    0's neighbour sets: within 1e-5 of scale of its plain version, and bit
    for bit the first design's output and its own on a second call."""
    nbr = torch.as_tensor(pair0[key]).to(cuda, torch.int32)
    res = selfcheck.check_gather_wf(nbr, pair0[f"points_{src}"].shape[1], ac,
                                    dtype=torch.float32, reps=1, first=True)
    _assert_ok(res)
    assert res.form == "rows" and res.bitwise, res.shape


@pytest.mark.parametrize("nq,ns,h,ac,k", [
    (250, 997, 24, 192, 1),      # K 1 and 16
    (250, 997, 24, 192, 16),
    (250, 997, 1, 192, 15),      # H 1, 17 (past 16) and 64 (two full ballot words)
    (250, 997, 17, 192, 15),
    (1003, 2000, 64, 192, 15),
    (250, 997, 36, 44, 15),      # AC of 4 but not of the slice: one slice of 11 units
    (250, 997, 36, 776, 15),     # 7 slices of 28 units, the last of 26
    (250, 997, 5, 4, 15),        # one unit a row
    (1003, 2000, 24, 196, 15),   # 49 units: 2 slices of 25, the last of 24
    (7, 50, 5, 40, 3),           # fewer items than warps
])
def test_gather_wf_rows_edges(cuda, nq, ns, h, ac, k):
    """K1's rows form at ragged widths, with about a quarter sentinel
    neighbours and the last 3 query rows all sentinels: within 1e-5 of
    scale of the plain version, bit for bit against the first design and a
    second call of itself."""
    nbr = _conv_neighbors(cuda, nq, ns, h, 23)
    res = selfcheck.check_gather_wf(nbr, ns, ac, k=k, dtype=torch.float32, reps=1, first=True)
    _assert_ok(res)
    assert res.form == "rows" and res.bitwise, res.shape


def test_gather_wf_rows_reads_padded_influence_in_place(cuda):
    """The rows form reads the first H of H' > H influence columns as they
    lie, skips sentinels (== Ns) and negative indices whatever their
    influence, gives the first design's bits on these inputs and on the
    unpadded copy, and exactly +0.0 on all-sentinel rows."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(24)
    nq, ns, h = 1003, 2000, 36
    nbr = _conv_neighbors(cuda, nq, ns, h, 24)
    nbr[:, ::7, 3] = -1
    x = torch.randn((2, ns, 768), generator=g).to(cuda)
    infl = torch.rand((2, nq, h + 12, 15), generator=g).to(cuda)  # weights on sentinels too
    got = wc.gather_wf(x, nbr, infl)
    assert wc.gather_wf_form(h, torch.float32, 15, 768) == "rows"
    assert torch.equal(_bits(got), _bits(wc._gather_wf_forward(x, nbr, infl, form="first")))
    assert torch.equal(_bits(got), _bits(wc.gather_wf(x, nbr, infl[:, :, :h].contiguous())))
    assert not bool(_bits(got[:, -3:]).any())
    valid = (nbr >= 0) & (nbr < ns)
    want = wc.gather_wf_plain(x, nbr.clamp(0, ns), infl[:, :, :h] * valid[..., None])
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("offset", [1, 4])
def test_gather_wf_rows_takes_a_view_at_an_offset(cuda, offset):
    """x as a view ``offset`` floats into a buffer: rows off 16-byte
    boundaries (offset 1) are copied by the wrapper, aligned ones (offset
    4) read in place; both give the first design's bits."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(25)
    nq, ns, h, ac = 250, 997, 24, 192
    nbr = _conv_neighbors(cuda, nq, ns, h, 25)
    buf = torch.randn((2 * ns * ac + offset,), generator=g).to(cuda)
    x = buf[offset:].view(2, ns, ac)
    infl = torch.rand((2, nq, h, 15), generator=g).to(cuda) * (nbr < ns)[..., None]
    assert (x.data_ptr() % 16 != 0) == (offset == 1)
    got = wc.gather_wf(x, nbr, infl)
    assert torch.equal(_bits(got), _bits(wc._gather_wf_forward(x, nbr, infl, form="first")))


def test_gather_wf_rows_refuses_what_it_cannot_take(cuda):
    """No fallback: the rows form asked for at H 65 or in bf16 raises; the
    first design takes H 65 in float32."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr = torch.zeros((1, 4, 65), dtype=torch.int32, device=cuda)
    x = torch.zeros((1, 10, 8), device=cuda)
    infl = torch.zeros((1, 4, 65, 15), device=cuda)
    assert wc.gather_wf_form(65, torch.float32, 15, 8) == "first"
    with pytest.raises(ValueError, match="rows form"):
        wc._gather_wf_forward(x, nbr, infl, form="rows")
    with pytest.raises(ValueError, match="rows form"):
        wc._gather_wf_forward(x.to(torch.bfloat16), nbr[:, :, :8], infl[:, :, :8], form="rows")
    assert wc.gather_wf(x, nbr, infl).shape == (1, 4, 15 * 8)


def test_gather_wf_rows_plan_matches_the_kernel(cuda):
    """The wrapper's plan (form, slices, units a slice) is the C entry
    point's, at H 0-66, K 0-17 and AC 0-1600."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    fn = _build._library("gather_wf").se3et_gather_wf_rows_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    shapes = [(h, k, 192) for h in range(67) for k in range(18)]
    shapes += [(24, 15, ac) for ac in range(1601)]
    for h, k, ac in shapes:
        out = (ctypes.c_int * 2)()
        form = fn(h, k, ac, out)
        assert ({1: "rows", 0: "first"}[form], *out) == tuple(wc.gather_wf_rows_plan(h, k, ac)), \
            (h, k, ac)


def _bits(t):
    """The bit patterns of a bf16 or float32 tensor (-0.0 apart from +0.0)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _k2_neighbors(cuda, nq, ns, h, seed):
    """(2, nq, h) local neighbour rows, about a quarter sentinels, with rows
    5-9 of each cloud without a sentinel and the last 3 all sentinels."""
    g = torch.Generator().manual_seed(seed)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    nbr[:, 5:10] = nbr[:, 5:10].clamp_max(ns - 1)
    nbr[:, -3:] = ns
    return nbr


@pytest.mark.parametrize("nq,ns,h,ac", [
    (10000, 20000, 24, 768),   # s0 -> s1 skip (unfused route, training)
    (2500, 10000, 32, 1536),   # s1 -> s2
    (1024, 2500, 36, 3072),    # s2 -> s3 (the fused serving route's K2)
    (1024, 2500, 38, 3072),
    *((1003, 2500, h, ac) for ac in (768, 1536, 3072) for h in (24, 32, 36, 40)),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["rows", "first"])
def test_neighbor_max_kernel(cuda, nq, ns, h, ac, dtype, form):
    """K2, each form, bit for bit against its plain version at the skips'
    widths and H 24-40 (past 32: a second word of the rows form's slot
    mask), with sentinel slots, rows without one and rows of only
    sentinels; the wrapper runs the form neighbor_max_form names."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr = _k2_neighbors(cuda, nq, ns, h, 1)
    x = torch.randn((2, ns, ac), generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    got = wc._neighbor_max_forward(x, nbr, form)
    assert torch.equal(_bits(got), _bits(wc.neighbor_max_plain(x, nbr)))
    assert not bool(got[:, -3:].any())
    if form == wc.neighbor_max_form(ac, dtype):
        assert torch.equal(_bits(wc.neighbor_max(x, nbr)), _bits(got))


@pytest.mark.parametrize("ac,dtype", [(30, torch.bfloat16), (6, torch.float32),
                                      (8, torch.bfloat16), (4, torch.float32),
                                      (776, torch.bfloat16)])
def test_neighbor_max_kernel_narrow_and_ragged_rows(cuda, ac, dtype):
    """Rows that are not whole 16-byte units take the first design, and the
    rows form refuses them (a raise, never another kernel); one-unit rows
    and a last slice of a single unit (AC 776 bf16: 97 units in slices of
    64) take the rows form.  Bit for bit against the plain version."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr = _k2_neighbors(cuda, 997, 500, 36, 2)
    x = torch.randn((2, 500, ac), generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    form = wc.neighbor_max_form(ac, dtype)
    assert form == ("first" if ac * x.element_size() % 16 else "rows")
    assert torch.equal(_bits(wc.neighbor_max(x, nbr)), _bits(wc.neighbor_max_plain(x, nbr)))
    if form == "first":
        with pytest.raises(RuntimeError):
            wc._neighbor_max_forward(x, nbr, "rows")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["rows", "first"])
def test_neighbor_max_signed_zeros(cuda, dtype, form):
    """Zeros of both signs, H 40.  Every payload value is below zero but for
    -0.0 in the even channels of source rows 0-3.  Query rows: 0, -0.0
    rows beside a sentinel (slot 1) and negative rows; 1, the same with
    the sentinel first and a -0.0 row in the second word of slots; 2, -0.0
    rows and negative rows, no sentinel; 3, negative rows and one sentinel
    (slot 37, in the second word); 4, only sentinels; the rest local
    neighbours.  Both forms equal each other bit for bit, and give +0.0
    wherever a sentinel meets -0.0: the card's max orders +0.0 above -0.0.
    The plain version (torch.amax) keeps one of two equal values as its
    reduction order falls, so at those entries the test holds only its
    value (zero); everywhere else it holds its bits: -0.0 in row 2's even
    channels, +0.0 in rows 3 and 4."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    ns, nq, h, ac = 64, 200, 40, 768
    g = torch.Generator().manual_seed(3)
    x = -(torch.rand((2, ns, ac), generator=g) + 0.5)
    x[:, :4, 0::2] = -0.0
    x = x.to(cuda, dtype)
    nbr = _k2_neighbors(cuda, nq, ns, h, 3)
    rows = torch.arange(10, 10 + h, dtype=torch.int32).repeat(5, 1)  # negative rows
    rows[0, :3] = torch.tensor([0, ns, 1])
    rows[1, :2] = torch.tensor([ns, 2])
    rows[1, 35] = 3
    rows[2, :2] = torch.tensor([0, 3])
    rows[3, 37] = ns
    rows[4] = ns
    nbr[:, :5] = rows.to(cuda)
    got = wc._neighbor_max_forward(x, nbr, form)
    other = wc._neighbor_max_forward(x, nbr, "first" if form == "rows" else "rows")
    want = wc.neighbor_max_plain(x, nbr)
    assert torch.equal(_bits(got), _bits(other))
    zero = torch.zeros((), dtype=dtype, device=cuda)
    neg_zero = -zero
    sentinel = (nbr >= ns).any(dim=2)[..., None]  # (2, nq, 1)
    valid = torch.where(nbr < ns, nbr, 0).long()
    gathered = torch.stack([x[b][valid[b]] for b in range(2)])  # (2, nq, h, ac)
    minus_zero = ((_bits(gathered) == _bits(neg_zero)) & (nbr < ns)[..., None]).any(dim=2)
    mixed = sentinel & minus_zero
    assert bool(mixed[:, :2, 0::2].all()) and not bool(mixed[:, 2:5].any())
    assert torch.equal(_bits(got[mixed]), _bits(zero).expand(int(mixed.sum())))
    assert torch.equal(got[mixed], want[mixed])
    assert torch.equal(_bits(got[~mixed]), _bits(want[~mixed]))
    assert bool((_bits(got[:, 2, 0::2]) == _bits(neg_zero)).all())
    assert not bool(_bits(got[:, 3:5]).any())


@pytest.mark.parametrize("negative", [False, True])
def test_neighbor_max_equals_k13_pooled(cuda, pair_subsampling, negative):
    """K2 and K13's skip max take the same routine (skip_max.cuh): on pair
    0's s0 -> s1 neighbours and a (2, 20000, 768) bf16 payload (below zero
    with ``negative``) K2's output is K13's pooled bit for bit."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr, ns = pair_subsampling
    nbr = nbr.to(cuda)
    x, infl, rhs, x2 = _k13_inputs(cuda, nbr, ns, 192, 192, 768, 15, 27, negative)
    assert wc.gather_wf_max_mm_form(nbr.shape[2], torch.bfloat16, 768) == "tc"
    with torch.no_grad():
        _, pooled = wc.gather_wf_max_mm(x, nbr, infl, x2, rhs)
    assert torch.equal(_bits(wc.neighbor_max(x2, nbr)), _bits(pooled))


def test_neighbor_max_bwd_reads_the_new_out(cuda):
    """K9 (the backward, which reads K2's saved ``out`` for its ties) gives
    the same gradient, bit for bit, on the rows form's output as on the
    plain version's, called directly and through autograd (float32, the
    training dtype, s0 -> s1 widths)."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nq, ns, h, ac = 10000, 20000, 24, 768
    nbr = _k2_neighbors(cuda, nq, ns, h, 4)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, ns, ac), generator=g).to(cuda)
    dout = torch.randn((2, nq, ac), generator=g).to(cuda)
    assert wc.neighbor_max_form(ac, torch.float32) == "rows"
    want = wc.neighbor_max_bwd(dout, x, wc.neighbor_max_plain(x, nbr), nbr)
    assert torch.equal(wc.neighbor_max_bwd(dout, x, wc.neighbor_max(x, nbr), nbr), want)
    xg = x.clone().requires_grad_(True)
    wc.neighbor_max(xg, nbr).backward(dout)
    assert torch.equal(xg.grad, want)


def test_neighbor_max_plan_matches_the_kernel(cuda):
    """The wrapper's plan (form, units a lane, slices, rows in flight, warps
    a block) is the C entry point's, at every width up to 4100."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    fn = _build._library("neighbor_max").se3et_neighbor_max_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    codes = {code: name for name, code in wc.NEIGHBOR_MAX_FORMS.items()}
    for dtype, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
        for ac in range(1, 4100):
            out = (ctypes.c_int * 5)()
            form = fn(ac, nbytes, out)
            assert (codes[form], *out[1:]) == tuple(wc.neighbor_max_plan(ac, dtype)), (ac, dtype)


@pytest.mark.parametrize("n,c,out_dtype", [
    (1024, 256, torch.bfloat16),   # serving shape
    (1024, 256, torch.float32),
    (1003, 256, torch.bfloat16),   # ragged N (keys past the last 32-key tile)
    (128, 64, torch.bfloat16),     # tiny training widths (bf16 embedding)
    (100, 512, torch.bfloat16),    # two staged channel blocks
])
def test_geometric_embedding_kernel(cuda, n, c, out_dtype):
    g = torch.Generator().manual_seed(2)
    points = (torch.rand((2, n, 3), generator=g) * 4 - 2).to(cuda)
    masks = torch.ones((2, n), dtype=torch.bool, device=cuda)
    masks[1, -40:] = False
    points[1, -40:] = 0.0
    _assert_ok(selfcheck.check_embedding(points, masks, c=c, out_dtype=out_dtype, reps=1))


def test_sinkhorn_kernel(cuda):
    _assert_ok(selfcheck.check_sinkhorn(device=cuda, reps=1))


@pytest.mark.parametrize("m,n", [(2, 2), (17, 9), (65, 65), (65, 33), (129, 129)])
@pytest.mark.parametrize("iters", [0, 1, 100])
@pytest.mark.parametrize("form", ["rows", "smem"])
@pytest.mark.parametrize("peak", [None, 176.0])
def test_sinkhorn_kernel_edges(cuda, m, n, iters, form, peak):
    """K4, each form, against its plain version on 8 patches: one with every
    row masked, one with every column masked, one with a single valid entry,
    the rest with about a fifth of rows and columns masked; with valid
    scores up to 176 too (as the seed-0 weights give entry()'s pair).
    Within 1e-4 on valid entries, finite wherever the plain version is."""
    _assert_ok(selfcheck.check_sinkhorn(b=8, m=m, n=n, iters=iters, device=cuda, reps=1,
                                        form=form, single_entry=True, peak=peak))


@pytest.mark.parametrize("m,n", [(144, 144), (145, 145), (168, 168), (3, 6000)])
def test_sinkhorn_kernel_at_the_largest_shapes(cuda, m, n):
    """K4 on the form its plan names at the edges of the rows form (144) and
    of the first design's shared memory (168 x 168, lopsided)."""
    _assert_ok(selfcheck.check_sinkhorn(b=4, m=m, n=n, iters=20, device=cuda, reps=1,
                                        single_entry=True))


def test_sinkhorn_plan_matches_the_kernel(cuda):
    """The wrapper's plan (form, lanes, slice width, warps, patches per
    block, shared bytes) is the C entry point's."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import sinkhorn as sk

    fn = _build._library("sinkhorn").se3et_sinkhorn_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    codes = {code: name for name, code in sk.FORM_CODES.items()}
    shapes = [(m, n) for m in (1, 2, 9, 17, 33, 64, 65, 100, 129, 144, 145, 168, 169)
              for n in (1, 2, 13, 33, 65, 129, 145, 168, 200)] + [(1, 11621), (1, 11622)]
    for m, n in shapes:
        out = (ctypes.c_int * 6)()
        form = fn(m, n, out)
        try:
            want = sk.sinkhorn_plan(m, n)
        except ValueError:
            assert form == 0 and out[0] == 0, (m, n)
            continue
        assert (codes[form], *out[1:]) == tuple(want), (m, n)


def _cloud(cuda, n, seed, pad=40):
    """(2, n, 3) points in a 4 m box with ``pad`` padded (zero, masked)
    points at the end of cloud 1, and their (2, n) masks."""
    g = torch.Generator().manual_seed(seed)
    points = (torch.rand((2, n, 3), generator=g) * 4 - 2).to(cuda)
    masks = torch.ones((2, n), dtype=torch.bool, device=cuda)
    masks[1, -pad:] = False
    points[1, -pad:] = 0.0
    return points, masks


# (N, padded keys at the end of cloud 1): the serving shape, whose last 40
# masked keys leave key tile 992-1023 wholly masked; ragged N; one key past
# a tile; fewer rows than a block; two wholly masked tiles
RPE_EDGES = [(1024, 40), (1003, 40), (33, 5), (12, 3), (1003, 72)]


@pytest.mark.parametrize("n,ah,c,cc,with_sh,dtype,pad", [
    (1024, 24, 64, 256, True, torch.bfloat16, 40),    # self_eq layers
    (1024, 4, 64, 256, False, torch.bfloat16, 40),    # plain self layers
    (1003, 24, 64, 256, True, torch.bfloat16, 40),    # ragged N
    (1003, 4, 64, 256, False, torch.bfloat16, 40),
    (33, 24, 64, 256, True, torch.bfloat16, 5),       # one key past a tile
    (33, 4, 64, 256, False, torch.bfloat16, 5),
    (12, 24, 64, 256, True, torch.bfloat16, 3),       # fewer rows than a block
    (12, 4, 64, 256, False, torch.bfloat16, 3),
    (1003, 24, 64, 256, True, torch.bfloat16, 72),    # two wholly masked key tiles
    (1003, 4, 64, 256, False, torch.bfloat16, 72),
    (128, 24, 16, 64, True, torch.float32, 40),       # tiny card-vs-CPU widths
    (128, 4, 16, 64, False, torch.float32, 40),
    (1024, 24, 64, 256, False, torch.bfloat16, 40),   # se3eti self_eq layers: no SH term
    (1003, 24, 64, 256, False, torch.bfloat16, 72),   # the same, ragged, two masked tiles
    (12, 24, 64, 256, False, torch.bfloat16, 3),      # the same, fewer rows than a block
    (128, 24, 16, 64, False, torch.float32, 40),      # tiny se3eti widths
    # head width 32 (the wide-head family, C = 128): the CUDA-core form
    (1024, 24, 32, 128, True, torch.bfloat16, 40),    # se3ete2 self_eq layers
    (1024, 4, 32, 128, False, torch.bfloat16, 40),    # its plain self layers
    (1024, 24, 32, 128, False, torch.bfloat16, 40),   # se3eti2 self_eq layers: no SH
    (1003, 24, 32, 128, True, torch.bfloat16, 72),    # ragged, two masked key tiles
    (1003, 4, 32, 128, False, torch.bfloat16, 72),
    (33, 24, 32, 128, True, torch.bfloat16, 5),       # one key past a tile
    (12, 4, 32, 128, False, torch.bfloat16, 3),       # fewer rows than a block
    (1024, 24, 32, 128, True, torch.float32, 40),     # float32 at the family's widths
    (128, 4, 32, 128, False, torch.float32, 40),
])
def test_rpe_attention_kernel(cuda, n, ah, c, cc, with_sh, dtype, pad):
    points, masks = _cloud(cuda, n, 4, pad=pad)
    _assert_ok(selfcheck.check_rpe_attention(points, masks, ah, c=c, cc=cc,
                                             with_sh=with_sh, dtype=dtype, reps=1))


def test_rpe_attention_ws_form_without_sh(cuda):
    """At se3eti's self_eq shape (AH = 24, no SH term) K5 takes its ws form,
    which reserves the block's SH queries and reads none: the output equals
    a second call bit for bit and stays within tolerance of the plain
    version."""
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    assert rpe.rpe_attention_form(24, 64, 256, torch.bfloat16) == "ws"
    points, masks = _cloud(cuda, 1024, 11, pad=40)
    g = torch.Generator().manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=g).to(cuda, torch.bfloat16)  # noqa: E731
    q, k, v, emb = rnd(2, 24, 1024, 64), rnd(2, 24, 1024, 64), rnd(2, 24, 1024, 64), \
        rnd(2, 1024, 1024, 256)
    qp = rnd(2, 1024, 24, 256) * 0.0625
    first = rpe.rpe_self_attention(q, k, v, qp, emb, masks, scale=0.125)
    second = rpe.rpe_self_attention(q, k, v, qp, emb, masks, scale=0.125)
    assert torch.equal(first, second)
    want = rpe.rpe_self_attention_plain(q, k, v, qp, emb, masks, scale=0.125)
    rows = masks[:, None, :, None].expand_as(want)
    err = float((first - want)[rows].abs().max())
    assert err <= 1e-2 * float(want[rows].abs().max()), err


def test_rpe_attention_ws_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory plan of K5's ws form is the kernel's."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    fn = getattr(_build._library("rpe_attention"), "se3et_rpe_attention_ws_smem")
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    for ah, hc, cc in ((24, 64, 256), (4, 64, 256), (24, 64, 64), (4, 64, 512)):
        assert fn(ah, hc, cc) == rpe.ws_smem_bytes(ah, hc, cc)
    assert fn(24, 16, 64) == 0 and fn(24, 64, 48) == 0


EQ_MODES = ("sq", None, "abs", "relu", "sigmoid", "leakyrelu", "softplus", "minus")


@pytest.mark.parametrize("n,m,c,dtype,positive", [
    (1024, 1024, 64, torch.bfloat16, "sq"),   # EQ cross layers
    (1003, 997, 64, torch.bfloat16, "sq"),    # ragged N and M
    (128, 128, 16, torch.float32, "sq"),      # tiny card-vs-CPU widths
    # head width 32 (se3ete2's EQ cross layers): the CUDA-core form
    (1003, 997, 32, torch.bfloat16, "sq"), (1024, 1024, 32, torch.float32, "sq"),
] + [(1024, 1024, 64, torch.bfloat16, mode) for mode in EQ_MODES[1:]]
  + [(1024, 1024, 32, torch.bfloat16, mode) for mode in EQ_MODES])
@pytest.mark.parametrize("with_sup", [False, True])
def test_eq_attention_stats_kernel(cuda, n, m, c, dtype, positive, with_sup):
    """K6 against its plain version in every positive() mode at the serving
    shape, with and without the supervision max; within 1e-3 of each
    output's scale."""
    qm = torch.arange(n, device=cuda) < n - 24
    km = torch.arange(m, device=cuda) < m - 40
    _assert_ok(selfcheck.check_eq_stats(qm, km, c=c, with_sup=with_sup, positive=positive,
                                        dtype=dtype, reps=1))


def _eq_edge_masks(case, n, m, device):
    qm = torch.arange(n, device=device) < max(n - 3, 1)
    km = torch.arange(m, device=device) < max(m - 5, 1)
    if case == "masked tiles":  # keys 64-191 and 320-383: whole 64-key tiles
        km[64:192] = False
        km[320:384] = False
    elif case == "no query row":
        qm[:] = False
    elif case == "one key":
        km[:] = False
        km[m // 2] = True
    elif case == "no key":
        km[:] = False
    return qm, km


@pytest.mark.parametrize("n,m,case", [
    (1, 1024, "ragged"), (17, 1024, "ragged"),          # fewer rows than a warp unit
    (1024, 1, "ragged"), (1024, 63, "ragged"),          # M not a multiple of the tile
    (1024, 997, "ragged"),
    (1024, 1024, "masked tiles"), (1003, 997, "masked tiles"),
    (1024, 1024, "no query row"), (1024, 1024, "one key"), (17, 63, "one key"),
])
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 64), (torch.float32, 16),
                                     (torch.bfloat16, 32), (torch.float32, 32)])
@pytest.mark.parametrize("with_sup", [False, True])
def test_eq_attention_stats_kernel_edges(cuda, n, m, case, dtype, c, with_sup):
    """K6 (both forms) at shapes and masks off the serving path: N = 1 and
    17, M = 1, 63 and 997, whole masked key tiles (skipped by the tc form),
    every query row masked, a single valid key; within 1e-3 of each output's
    scale."""
    qm, km = _eq_edge_masks(case, n, m, cuda)
    _assert_ok(selfcheck.check_eq_stats(qm, km, c=c, with_sup=with_sup, dtype=dtype, reps=1))


def test_eq_attention_stats_plan_matches_the_kernel(cuda):
    """The wrapper's partial-slot count and the tc form's shared-memory plan
    are the kernel's."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import eq_attention as eq

    lib = _build._library("eq_attention")
    parts = lib.se3et_eq_attention_stats_parts
    parts.argtypes = [ctypes.c_int] * 4
    parts.restype = ctypes.c_int
    for n in (1, 17, 1003, 1024):
        for c, dtype in ((64, torch.bfloat16), (16, torch.bfloat16), (64, torch.float32),
                         (16, torch.float32), (32, torch.bfloat16), (32, torch.float32)):
            assert parts(4, n, c, int(dtype == torch.bfloat16)) == \
                eq.eq_attention_stats_parts(4, n, c, dtype)
    assert parts(8, 1024, 64, 1) == 0 and parts(4, 1024, 128, 1) == 0
    smem = lib.se3et_eq_attention_stats_smem
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_longlong
    for m in (1, 63, 64, 997, 1024, 5000):
        assert smem(m) == eq.eq_stats_smem_bytes(m)
    occupancy = lib.se3et_eq_attention_stats_blocks_per_sm
    occupancy.argtypes = [ctypes.c_int]
    occupancy.restype = ctypes.c_int
    assert occupancy(1024) == 1


@pytest.mark.parametrize("n,m,c,dtype", [
    (1024, 1024, 64, torch.bfloat16),
    (1003, 997, 64, torch.bfloat16),
    (128, 128, 16, torch.float32),
    (1024, 1024, 32, torch.bfloat16),   # head width 32 (se3ete2): the CUDA-core form
    (1003, 997, 32, torch.bfloat16),
    (1024, 1024, 32, torch.float32),
])
def test_eq_attention_apply_kernel(cuda, n, m, c, dtype):
    qm = torch.arange(n, device=cuda) < n - 24
    km = torch.arange(m, device=cuda) < m - 40
    _assert_ok(selfcheck.check_eq_apply(qm, km, c=c, dtype=dtype, reps=1))


@pytest.mark.parametrize("n,m,case", [
    (1, 1024, "ragged"), (17, 1024, "ragged"), (1003, 1024, "ragged"),  # N off the unit
    (1024, 1, "ragged"), (1024, 63, "ragged"), (1024, 997, "ragged"),   # M off the tile
    (1024, 1024, "masked tiles"), (1003, 997, "masked tiles"),
    (1024, 1024, "one key"), (17, 63, "one key"),
    (1024, 1024, "no key"), (17, 63, "no key"),
    (1024, 1024, "zero w row"),
])
@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 64), (torch.float32, 16),
                                     (torch.bfloat16, 32), (torch.float32, 32)])
def test_eq_attention_apply_kernel_edges(cuda, n, m, case, dtype, c):
    """K7 (both forms) at shapes and masks off the serving path: N = 1, 17
    and 1003, M = 1, 63 and 997, whole masked key tiles (skipped by the tc
    form), a single valid key, no valid key (the output 0 and finite) and
    an anchor whose weights are all zero; within the tolerance of
    ``selfcheck.check_eq_apply``."""
    from se3et_tpu_torch.ops.kernels import eq_attention as eq

    qm, km = _eq_edge_masks(case, n, m, cuda)
    zero = (2,) if case == "zero w row" else ()
    _assert_ok(selfcheck.check_eq_apply(qm, km, c=c, dtype=dtype, reps=1, zero_rows=zero))
    if case == "no key":
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(s, generator=g).to(cuda, dtype)
                   for s in ((6, 4, n, c), (6, 4, m, c), (6, 4, m, c)))
        rowmax, rowsum, _ = eq.eq_attention_stats_plain(q, k, qm, km)
        out = eq.eq_attention_apply(q, k, v, torch.full((6, 6), 1 / 6, device=cuda), rowmax,
                                    rowsum, km)
        assert bool((out == 0).all()), float(out.abs().max())


def test_eq_attention_apply_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory plan of K7's tc form is the kernel's, and
    one block of it is resident per SM at the serving M."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import eq_attention as eq

    lib = _build._library("eq_attention")
    smem = lib.se3et_eq_attention_apply_smem
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_longlong
    for m in (1, 63, 64, 997, 1024, 5000):
        assert smem(m) == eq.eq_apply_smem_bytes(m)
    occupancy = lib.se3et_eq_attention_apply_blocks_per_sm
    occupancy.argtypes = [ctypes.c_int]
    occupancy.restype = ctypes.c_int
    assert occupancy(1024) == 1


@pytest.mark.parametrize("nq,ns,h,ac", [
    (20000, 20000, 24, 192),   # stage-0 bottleneck conv
    (10000, 20000, 24, 192),   # stage-1 strided conv
    (1024, 1024, 38, 1536),    # stage-3 conv
    (250, 997, 7, 48),         # ragged, tiny
])
def test_gather_wf_bwd_kernel(cuda, nq, ns, h, ac):
    g = torch.Generator().manual_seed(7)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    _assert_ok(selfcheck.check_gather_wf_bwd(nbr, ns, ac, reps=1))


def _k8_neighbors(cuda, nq, ns, h, kind, seed):
    """Two clouds of neighbour rows for K8: local (about a quarter
    sentinels), "random" over all sources (no locality), "sentinel_rows"
    (local, every fifth row and the last 3 all sentinels) or "empty_range"
    (local, no slot in the middle third of the sources: whole empty tiles)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "random":
        nbr = torch.randint(0, ns, (2, nq, h), generator=g).to(torch.int32)
        nbr[torch.rand((2, nq, h), generator=g) < 0.25] = ns
        return nbr.to(cuda)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    if kind == "sentinel_rows":
        nbr[:, ::5] = ns
        nbr[:, -3:] = ns
    elif kind == "empty_range":
        lo, hi = ns // 3, 2 * ns // 3
        nbr[(nbr >= lo) & (nbr < hi)] = ns
    return nbr


@pytest.mark.parametrize("nq,ns,h,ac,kind", [
    (20000, 20000, 24, 192, "local"),        # stage-0 bottleneck conv
    (10000, 20000, 24, 192, "local"),        # stage-1 strided conv
    (1024, 1024, 38, 1536, "local"),         # stage-3 conv
    (250, 997, 7, 48, "local"),              # ragged, tiny
    (10000, 10000, 32, 384, "random"),       # no locality: a run a slot
    (2500, 2500, 36, 768, "sentinel_rows"),  # all-sentinel query rows
    (2500, 10000, 32, 384, "empty_range"),   # sources no slot reaches
    (1003, 2000, 64, 44, "local"),           # H at the plan's limit, AC not of 8
    (1003, 2000, 24, 45, "local"),           # AC not of 4: the first design
])
def test_gather_wf_bwd_tiles_is_bit_identical(cuda, nq, ns, h, ac, kind):
    """K8 on the form its shape takes (the tiles form but at AC 45) against
    its plain version (1e-5 of scale), bit for bit against its first design
    and against a second call of itself."""
    nbr = _k8_neighbors(cuda, nq, ns, h, kind, 31)
    res = selfcheck.check_gather_wf_bwd(nbr, ns, ac, reps=1, first=True)
    _assert_ok(res)
    assert res.bitwise, res.shape


@pytest.mark.parametrize("nq,ns,h,ac,kind", [(1003, 2000, 24, 192, "local"),
                                             (997, 997, 36, 776, "sentinel_rows")])
def test_gather_wf_bwd_tiles_reads_padded_influence_in_place(cuda, nq, ns, h, ac, kind):
    """The tiles form reads an influence of H' = H + 3 columns in place (its
    stride over H') and gives the first design's bits, on ragged local
    neighbours and on ones with all-sentinel rows."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(32)
    nbr = _k8_neighbors(cuda, nq, ns, h, kind, 32)
    dwf = torch.randn((2, nq, 15 * ac), generator=g).to(cuda)
    infl = torch.rand((2, nq, h + 3, 15), generator=g).to(cuda) * torch.nn.functional.pad(
        (nbr < ns), (0, 3))[..., None]
    assert wc.gather_wf_bwd_form(nq, h, 15, ac) == "tiles"
    want = wc._gather_wf_bwd(dwf, nbr, infl, ns, form="first")
    got = wc.gather_wf_bwd(dwf, nbr, infl, ns)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("nq,ns,h,kind", [
    (20000, 20000, 24, "local"),          # stage-0 set
    (10000, 20000, 24, "local"),          # strided: fewer queries than sources
    (250, 997, 7, "local"),               # ragged: Ns not a multiple of the tile
    (10000, 10000, 32, "random"),         # no locality
    (2500, 2500, 36, "sentinel_rows"),
    (2500, 10000, 32, "empty_range"),     # whole tiles no slot reaches
    (1003, 2000, 64, "local"),            # H at the plan's limit
    (1003, 2000, 24, "negative"),         # negative slots, dropped
])
def test_gather_wf_bwd_tile_plan_kernel(cuda, nq, ns, h, kind):
    """The tile plan merged on the card from the reverse index equals its
    plain version (``windowed_conv.tile_plan``: a sort of its own) in its
    offsets and in every entry it lists; the K8 call on it gives the first
    design's bits."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr = _k8_neighbors(cuda, nq, ns, h, "local" if kind == "negative" else kind, 35)
    if kind == "negative":
        nbr[:, ::7, 3] = -1
    assert selfcheck.tile_plan_matches(nbr, ns)
    g = torch.Generator().manual_seed(35)
    dwf = torch.randn((2, nq, 15 * 16), generator=g).to(cuda)
    infl = torch.rand((2, nq, h, 15), generator=g).to(cuda)
    want = wc._gather_wf_bwd(dwf, nbr, infl, ns, form="first")
    got = wc.gather_wf_bwd(dwf, nbr, infl, ns)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gather_wf_bwd_tiles_allocates_no_slot_tensor(cuda):
    """At the stage-0 shape the tiles call (its plan built) allocates dx and
    a counter, nothing of the first design's (B, Nq*H, AC) slot tensor."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nq, h, ac, k = 20000, 24, 192, 15
    g = torch.Generator().manual_seed(33)
    nbr = torch.cat([selfcheck.local_neighbors(nq, nq, h, g, cuda) for _ in range(2)])
    dwf = torch.randn((2, nq, k * ac), generator=g).to(cuda)
    infl = torch.rand((2, nq, h, k), generator=g).to(cuda)
    peaks = {}
    for form in ("tiles", "first"):
        wc._gather_wf_bwd(dwf, nbr, infl, nq, form=form)  # the plan or reverse index
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        dx = wc._gather_wf_bwd(dwf, nbr, infl, nq, form=form)
        torch.cuda.synchronize()
        peaks[form] = torch.cuda.max_memory_allocated(cuda) - base
        del dx
    dx_bytes, slot_bytes = 2 * nq * ac * 4, 2 * nq * h * ac * 4
    assert peaks["tiles"] <= dx_bytes + (1 << 20), peaks
    assert peaks["first"] - peaks["tiles"] >= slot_bytes, peaks


def test_gather_wf_bwd_tiles_takes_an_unaligned_view(cuda):
    """dwf as a view 4 bytes into a buffer (rows not 16-byte aligned): the
    tiles form copies it and gives the first design's bits."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nq, ns, h, ac = 250, 997, 7, 48
    g = torch.Generator().manual_seed(34)
    nbr = _k8_neighbors(cuda, nq, ns, h, "local", 34)
    buf = torch.randn((2 * nq * 15 * ac + 1,), generator=g).to(cuda)
    dwf = buf[1:].view(2, nq, 15 * ac)
    infl = torch.rand((2, nq, h, 15), generator=g).to(cuda) * (nbr < ns)[..., None]
    assert dwf.data_ptr() % 16
    want = wc._gather_wf_bwd(dwf, nbr, infl, ns, form="first")
    got = wc.gather_wf_bwd(dwf, nbr, infl, ns)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gather_wf_bwd_tiles_refuses_what_its_plan_cannot_hold(cuda):
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr = torch.zeros((1, 4, 65), dtype=torch.int32, device=cuda)
    dwf = torch.zeros((1, 4, 15 * 8), device=cuda)
    infl = torch.zeros((1, 4, 65, 15), device=cuda)
    assert wc.gather_wf_bwd_form(4, 65, 15, 8) == "first"
    with pytest.raises(ValueError, match="tiles form"):
        wc._gather_wf_bwd(dwf, nbr, infl, 10, form="tiles")
    assert wc.gather_wf_bwd(dwf, nbr, infl, 10).shape == (1, 10, 8)


@pytest.mark.parametrize("nq,ns,h,ac", [(10000, 20000, 24, 768), (1024, 2500, 38, 3072),
                                        (97, 250, 5, 40)])
def test_neighbor_max_bwd_kernel(cuda, nq, ns, h, ac):
    g = torch.Generator().manual_seed(8)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    _assert_ok(selfcheck.check_neighbor_max_bwd(nbr, ns, ac, reps=1))


# K9's training shapes: (neighbour set, source stage, A*C of the skip)
K9_TRAIN_SHAPES = (("subsampling_0", 0, 768), ("subsampling_1", 1, 1536),
                   ("subsampling_2", 2, 3072))


@pytest.mark.parametrize("key,src,ac", K9_TRAIN_SHAPES)
@pytest.mark.parametrize("kind", ["pair0", "local"])
def test_neighbor_max_bwd_tiles_is_bit_identical(cuda, pair0, key, src, ac, kind):
    """K9 takes its tiles form at the three strided skips of training, on
    pair 0's neighbour sets and on local neighbours of the same shape:
    within 1e-5 of scale of its plain version (integer-valued x, so many
    ties), and bit for bit the first design's dx and its own on a second
    call."""
    nbr = torch.as_tensor(pair0[key]).to(cuda, torch.int32)
    ns = pair0[f"points_{src}"].shape[1]
    if kind == "local":
        g = torch.Generator().manual_seed(40)
        nbr = torch.cat([selfcheck.local_neighbors(nbr.shape[1], ns, nbr.shape[2], g, cuda)
                         for _ in range(2)])
    res = selfcheck.check_neighbor_max_bwd(nbr, ns, ac, reps=1, first=True)
    _assert_ok(res)
    assert res.form == "tiles" and res.bitwise, res.shape


def _k9_inputs(cuda, nq, ns, h, ac, kind, seed):
    """(dout, x, out, nbr) for K9 on two clouds of local neighbours (about a
    quarter sentinels), ``out`` the forward max.  kinds: "local"; "ties"
    (x in {-1, 0, 1}); "shadow" (x <= 0 with +0 and -0 entries, out's zeros
    made -0 in every other row, so the shadow zeros of the sentinels tie
    out of either sign); "sentinel_rows" (every fifth query row and the
    last 3 all sentinels); "empty_range" (no slot in the middle third of
    the sources: whole tiles and rows no slot reaches); "negative" (every
    seventh row's slot 1 is -1, a shadow zero to the kernels)."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(seed)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    if kind == "sentinel_rows":
        nbr[:, ::5] = ns
        nbr[:, -3:] = ns
    elif kind == "empty_range":
        nbr[(nbr >= ns // 3) & (nbr < 2 * ns // 3)] = ns
    elif kind == "negative" and h > 1:
        nbr[:, ::7, 1] = -1
    if kind == "ties":
        x = torch.randint(-1, 2, (2, ns, ac), generator=g).float()
    elif kind == "shadow":
        x = -torch.rand((2, ns, ac), generator=g) - 0.5
        x[:, ::3] = 0.0
        x[:, 1::3, ::2] = -0.0
    else:
        x = torch.randint(-8, 9, (2, ns, ac), generator=g).float()
    x = x.to(cuda)
    out = wc.neighbor_max(x, nbr)
    if kind == "shadow":
        out[:, ::2][out[:, ::2] == 0] = -0.0
    return torch.randn((2, nq, ac), generator=g).to(cuda), x, out, nbr


def _k9_against_first(dout, x, out, nbr):
    """K9 on its tiles form: bit for bit its first design's dx, and within
    1e-5 of scale of the plain version on the same set with negative
    indices as sentinels (the kernels' reading of them)."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    ns = x.shape[1]
    assert wc.neighbor_max_bwd_form(nbr.shape[1], nbr.shape[2], x.shape[2]) == "tiles"
    got = wc.neighbor_max_bwd(dout, x, out, nbr)
    want = wc._neighbor_max_bwd(dout, x, out, nbr, form="first")
    assert torch.equal(_bits(got), _bits(want))
    plain = wc.neighbor_max_bwd_plain(dout, x, out, torch.where(nbr < 0, ns, nbr))
    assert float((got - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
    return got


@pytest.mark.parametrize("nq,ns,h,ac,kind", [
    (250, 997, 1, 48, "local"),          # H 1, 17 and 64
    (250, 997, 17, 48, "local"),
    (1003, 2000, 64, 48, "local"),
    (250, 997, 24, 4, "local"),          # AC 4, 12, and widths that are not whole slices
    (250, 997, 24, 12, "local"),
    (250, 997, 24, 200, "local"),
    (250, 997, 36, 776, "local"),
    (1, 40, 9, 768, "local"),            # Nq 1
    (30, 20, 9, 768, "local"),           # Ns under one tile
    (1003, 997, 24, 768, "ties"),        # Ns not a multiple of 32; many ties
    (2500, 2500, 36, 768, "shadow"),     # out of +0 and -0 beside sentinels
    (2500, 2500, 36, 192, "sentinel_rows"),
    (2500, 10000, 32, 384, "empty_range"),
    (1003, 2000, 24, 96, "negative"),
])
def test_neighbor_max_bwd_tiles_edges(cuda, nq, ns, h, ac, kind):
    """K9's tiles form at its edges, bit for bit against its first design;
    source rows no valid slot reaches get exactly +0."""
    dout, x, out, nbr = _k9_inputs(cuda, nq, ns, h, ac, kind, 41)
    got = _k9_against_first(dout, x, out, nbr)
    reached = torch.zeros((2, ns), dtype=torch.bool, device=cuda)
    valid = (nbr >= 0) & (nbr < ns)
    for i in range(2):
        reached[i, nbr[i][valid[i]].long()] = True
    assert not bool(_bits(got[~reached]).any())


@pytest.mark.parametrize("offset", [1, 2])
def test_neighbor_max_bwd_tiles_takes_views_at_an_offset(cuda, offset):
    """x, out and dout as views 4 or 8 bytes into their buffers (rows not
    16-byte aligned): the tiles form copies them and gives the first
    design's bits."""
    nq, ns, h, ac = 1003, 2000, 24, 96
    dout0, x0, out0, nbr = _k9_inputs(cuda, nq, ns, h, ac, "ties", 42)
    views = []
    for t in (dout0, x0, out0):
        buf = torch.empty(t.numel() + offset, device=cuda)
        buf[offset:] = t.reshape(-1)
        views.append(buf[offset:].view(t.shape))
    assert all(v.data_ptr() % 16 for v in views)
    dout, x, out = views
    got = _k9_against_first(dout, x, out, nbr)
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    assert torch.equal(_bits(got), _bits(wc.neighbor_max_bwd(dout0, x0, out0, nbr)))


def test_neighbor_max_bwd_tiles_refuses_what_its_plan_cannot_hold(cuda):
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr = torch.zeros((1, 4, 65), dtype=torch.int32, device=cuda)
    x = torch.zeros((1, 10, 8), device=cuda)
    dout = out = torch.zeros((1, 4, 8), device=cuda)
    assert wc.neighbor_max_bwd_form(4, 65, 8) == "first"
    with pytest.raises(ValueError, match="tiles form"):
        wc._neighbor_max_bwd(dout, x, out, nbr, form="tiles")
    assert wc.neighbor_max_bwd(dout, x, out, nbr).shape == (1, 10, 8)


@pytest.mark.parametrize("n,c,grad_dtype", [(1024, 256, torch.bfloat16),
                                            (1003, 256, torch.bfloat16),
                                            (128, 64, torch.bfloat16),
                                            (128, 64, torch.float32)])
def test_geometric_embedding_bwd_kernel(cuda, n, c, grad_dtype):
    points, masks = _cloud(cuda, n, 9)
    _assert_ok(selfcheck.check_embedding_bwd(points, masks, c=c, grad_dtype=grad_dtype,
                                             reps=1))


# (N, padded points at the end of cloud 1) for K10's tc form: the training
# shape; ragged N; fewer keys than one 64-key tile; a last tile of 8 keys
EMB_BWD_EDGES = [(1024, 40), (1003, 40), (40, 5), (200, 17)]


@pytest.mark.parametrize("n,pad", EMB_BWD_EDGES)
def test_geometric_embedding_bwd_tc_ties(cuda, n, pad):
    """K10's tc form on a cloud with repeated and near-tied neighbours and
    channels whose three angle projections are all 0 (``ties``), within
    1e-2 of each gradient's scale of the plain version."""
    points, masks = _cloud(cuda, n, 15, pad=pad)
    res = selfcheck.check_embedding_bwd(points, masks, ties=True, reps=1)
    assert res.shape.endswith("(tc form) (error relative to output scale)"), res.shape
    _assert_ok(res)


def _emb_bwd_args(cuda, n, c, dtype, seed, zero_cols=None):
    """K10's inputs as ``selfcheck.check_embedding_bwd`` makes them, with
    the columns ``zero_cols`` of wa set to 0."""
    points, masks = _cloud(cuda, n, seed)
    g = torch.Generator().manual_seed(seed)
    w = [((torch.rand(s, generator=g) * 2 - 1) * c ** -0.5).to(cuda)
         for s in ((c, c), (c,), (c, c), (c,))]
    if zero_cols is not None:
        w[2][:, zero_cols] = 0.0
    sq = torch.cdist(points, points).masked_fill(~masks[:, None, :], 1e10)
    idx = torch.topk(-sq, 4, dim=-1).indices[:, :, 1:]
    knn = torch.gather(points, 1, idx.reshape(2, -1, 1).expand(-1, -1, 3)).reshape(2, n, 3, 3)
    d_emb = torch.randn((2, n, n, c), generator=g).to(cuda, dtype)
    return (d_emb, points, knn, *w, 0.2, 15.0)


def test_geometric_embedding_bwd_tc_routes_ties_to_the_first_k(cuda):
    """Where a channel's three angle projections are all 0 (a zero column
    of wa), the tc form sends its whole gradient to T_a(angle_0), as the
    plain version does: those columns of d_wa within 1e-2 of their own
    scale of the plain version's, while routing them to angle_1 instead
    (the plain version with neighbours 0 and 1 swapped) moves them by more
    than 10 % of it."""
    from se3et_tpu_torch.ops.kernels import embedding

    cols = slice(0, None, 5)
    args = _emb_bwd_args(cuda, 1003, 256, torch.bfloat16, 17, zero_cols=cols)
    got = embedding.geometric_embedding_bwd(*args)[2][:, cols]
    want = embedding.geometric_embedding_bwd_plain(*args)[2][:, cols]
    swapped = list(args)
    swapped[2] = args[2][:, :, [1, 0, 2]]
    other = embedding.geometric_embedding_bwd_plain(*swapped)[2][:, cols]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-2 * scale
    assert float((other - want).abs().max()) > 0.1 * scale


def test_geometric_embedding_bwd_tc_is_deterministic(cuda):
    """Two calls of K10's tc form on the same inputs give the same gradients
    bit for bit: each block sums its fixed run of tiles in one order, and
    the wrapper adds the blocks' partials in a fixed order."""
    from se3et_tpu_torch.ops.kernels import embedding

    args = _emb_bwd_args(cuda, 1003, 256, torch.bfloat16, 18)
    first = embedding.geometric_embedding_bwd(*args)
    second = embedding.geometric_embedding_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


_PROFILE_K10 = """
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, sys.argv[1])
from tests.test_torch_kernels_cuda import _emb_bwd_args
from se3et_tpu_torch.ops.kernels import embedding
n, c, dtype, seed = int(sys.argv[2]), int(sys.argv[3]), getattr(torch, sys.argv[4]), int(sys.argv[5])
args = _emb_bwd_args(torch.device("cuda"), n, c, dtype, seed)
embedding.geometric_embedding_bwd(*args)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    embedding.geometric_embedding_bwd(*args)
    torch.cuda.synchronize()
print(json.dumps([e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]))
"""


def _k10_kernels(n, c, dtype, seed):
    """The device kernels one K10 call on ``_emb_bwd_args(n, c, dtype,
    seed)`` launches, from torch.profiler in a process of its own: a
    profiler session in this process would leave the later sessions of K11's
    launch test lossy on the card (they then lose kernel records)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _PROFILE_K10, root, str(n), str(c),
                          str(dtype).split(".")[-1], str(seed)],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert run.returncode == 0, run.stderr[-2000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype,form,kernel,other", [
    (torch.bfloat16, "tc", "embedding_bwd_tc_kernel", "embedding_bwd_kernel"),
    (torch.float32, "cuda", "embedding_bwd_kernel", "embedding_bwd_tc_kernel"),
])
def test_geometric_embedding_bwd_launches_its_form(cuda, dtype, form, kernel, other):
    """At the training shape (N = 1024, C = 256) K10 launches the tc form's
    kernel for a bf16 cotangent and the first design's for a float32 one
    (profiler)."""
    from se3et_tpu_torch.ops.kernels import embedding

    assert embedding.geometric_embedding_bwd_form(256, dtype) == form
    names = _k10_kernels(1024, 256, dtype, 19)
    assert any(kernel in k for k in names) and not any(other in k for k in names), names


def test_geometric_embedding_bwd_tc_refuses_other_widths(cuda):
    """K10 asked for its tc form at a width it is not built for raises;
    at that width a bf16 cotangent takes the first design (profiler)."""
    from se3et_tpu_torch.ops.kernels import embedding

    args = _emb_bwd_args(cuda, 100, 192, torch.bfloat16, 20)
    with pytest.raises(ValueError, match="tc form"):
        embedding._geometric_embedding_bwd(*args, form="tc")
    names = _k10_kernels(100, 192, torch.bfloat16, 20)
    assert any("embedding_bwd_kernel" in k for k in names), names


@pytest.mark.parametrize("n,ah,c,cc,with_sh,dtype", [
    (1024, 24, 64, 256, True, torch.bfloat16),    # self_eq layers
    (1024, 4, 64, 256, False, torch.bfloat16),    # plain self layers
    (1003, 24, 64, 256, True, torch.bfloat16),    # ragged N
    (1003, 4, 64, 256, False, torch.bfloat16),
    (128, 24, 16, 64, True, torch.bfloat16),      # tiny card-vs-CPU widths (training: bf16)
    (128, 4, 16, 64, False, torch.float32),
])
def test_rpe_attention_bwd_kernel(cuda, n, ah, c, cc, with_sh, dtype):
    points, masks = _cloud(cuda, n, 10)
    _assert_ok(selfcheck.check_rpe_attention_bwd(points, masks, ah, c=c, cc=cc,
                                                 with_sh=with_sh, dtype=dtype, reps=1))


# (N, padded keys at the end of cloud 1) for K11's tc form: 72 padded keys
# at N = 1003 mask the whole tiles 960-991 and 992-1002 (ragged) of cloud 1;
# the training shape; one key past a tile; fewer rows than a block (4) in
# the last block
RPE_BWD_EDGES = [(1003, 72), (1024, 40), (33, 5), (13, 3)]


@pytest.mark.parametrize("n,pad", RPE_BWD_EDGES)
@pytest.mark.parametrize("ah,with_sh", [(24, True), (4, False)])
def test_rpe_attention_bwd_tc_edges(cuda, n, ah, with_sh, pad):
    """K11's tc form at ragged N and masked key tails, within 1e-2 of each
    gradient's scale of the plain version."""
    points, masks = _cloud(cuda, n, 10, pad=pad)
    res = selfcheck.check_rpe_attention_bwd(points, masks, ah, with_sh=with_sh, reps=1)
    assert res.shape.endswith("(tc form) (error relative to output scale)"), res.shape
    _assert_ok(res)


def test_rpe_attention_bwd_tc_sh_diagonal(cuda):
    """The SH term where it is 0: on the n == m diagonal (rinv set to 0 by
    index) and at coincident points off it (cloud 0's second half repeats
    its first; cloud 1's padded points all sit at the origin), with the SH
    queries 10x the check's, so that the SH term leads the scores and dqw
    is large: the tc form within 1e-2 of each gradient's scale, dqw
    finite."""
    points, masks = _cloud(cuda, 64, 12, pad=8)
    points[0, 32:] = points[0, :32]
    _assert_ok(selfcheck.check_rpe_attention_bwd(points, masks, 24, reps=1, qw_scale=3.0))


def _rpe_bwd_args(cuda, n, ah, with_sh, seed):
    """K11's inputs as ``selfcheck.check_rpe_attention_bwd`` makes them
    (bf16, C = 256, head width 64), with K5's output and row statistics."""
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    points, masks = _cloud(cuda, n, seed)
    g = torch.Generator().manual_seed(seed)
    b = 2
    rnd = lambda *s: torch.randn(s, generator=g).to(cuda, torch.bfloat16)  # noqa: E731
    q, k, v, qp, emb = rnd(b, ah, n, 64), rnd(b, ah, n, 64), rnd(b, ah, n, 64), \
        rnd(b, n, ah, 256) * 0.0625, rnd(b, n, n, 256)
    qw = (torch.randn((b, 3, ah, n), generator=g) * 0.3).to(cuda) if with_sh else None
    pts = rpe.point_rows(points) if with_sh else None
    out, lse = rpe.rpe_self_attention_with_lse(q, k, v, qp, emb, masks, qw, pts, scale=0.125)
    dout = torch.randn((b, ah, n, 64), generator=g).to(cuda)
    return q, k, v, qp, emb, masks, qw, pts, dout, out, lse


@pytest.mark.parametrize("ah,with_sh", [(24, True), (4, True), (4, False)])
def test_rpe_attention_bwd_tc_is_deterministic(cuda, ah, with_sh):
    """Two calls of K11's tc form on the same inputs give the same gradients
    bit for bit: the kernel sums in one order (dqw gets at most two addends
    onto zero: at AH = 4 from two warps), and so do the products after it."""
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    args = _rpe_bwd_args(cuda, 1003, ah, with_sh, 13)
    first = rpe.rpe_attention_bwd(*args, scale=0.125)
    second = rpe.rpe_attention_bwd(*args, scale=0.125)
    for name, a, b in zip(("dq", "dk", "dv", "dqp", "demb", "dqw"), first, second):
        assert (a is None) == (b is None) == (name == "dqw" and not with_sh), name
        if a is not None:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype,form,kernel,other", [
    (torch.bfloat16, "tc", "rpe_attention_bwd_tc_kernel", "rpe_attention_bwd_kernel"),
    (torch.float32, "cuda", "rpe_attention_bwd_kernel", "rpe_attention_bwd_tc_kernel"),
])
def test_rpe_attention_bwd_launches_its_form(cuda, dtype, form, kernel, other):
    """At the self_eq training shape K11 launches the tc form's kernel in
    bf16 and the first design's in float32 (profiler), and agrees with the
    plain version (1e-2 / 1e-4 of each gradient's scale)."""
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    assert rpe.rpe_attention_bwd_form(24, 64, 256, dtype) == form
    args = [t.to(dtype) if t is not None and t.dtype == torch.bfloat16 else t
            for t in _rpe_bwd_args(cuda, 256, 24, True, 14)]
    call = lambda: rpe.rpe_attention_bwd(*args, scale=0.125)  # noqa: E731
    assert selfcheck.device_ms(call, kernel, reps=1) is not None
    assert selfcheck.device_ms(call, other, reps=1) is None
    points, masks = _cloud(cuda, 256, 14)
    res = selfcheck.check_rpe_attention_bwd(points, masks, 24, dtype=dtype, reps=1)
    assert f"({form} form)" in res.shape
    _assert_ok(res)


@pytest.mark.parametrize("ah,with_sh", [(24, True), (4, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rpe_attention_bwd_refuses_head_width_32(cuda, ah, with_sh, dtype):
    """K5 serves head width 32 (the wide-head family), K11 is not built for
    it: a backward through K5 at 32, by the wrapper, by a named form or by
    autograd, raises a ValueError naming K11 and the width before any
    launch."""
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    n, c, cc = 256, 32, 128
    points, masks = _cloud(cuda, n, 15)
    g = torch.Generator().manual_seed(15)
    rnd = lambda *s: torch.randn(s, generator=g).to(cuda, dtype)  # noqa: E731
    q, k, v, qp, emb = rnd(2, ah, n, c), rnd(2, ah, n, c), rnd(2, ah, n, c), \
        rnd(2, n, ah, cc) * 0.0625, rnd(2, n, n, cc)
    qw = (torch.randn((2, 3, ah, n), generator=g) * 0.3).to(cuda) if with_sh else None
    pts = rpe.point_rows(points) if with_sh else None
    out, lse = rpe.rpe_self_attention_with_lse(q, k, v, qp, emb, masks, qw, pts, scale=0.125)
    dout = torch.randn((2, ah, n, c), generator=g).to(cuda)
    before = rpe.rpe_attention_bwd.launches
    with pytest.raises(ValueError, match="K11.*head width 32"):
        rpe.rpe_attention_bwd(q, k, v, qp, emb, masks, qw, pts, dout, out, lse, scale=0.125)
    with pytest.raises(ValueError, match="K11.*head width 32"):
        rpe._rpe_attention_bwd(q, k, v, qp, emb, masks, qw, pts, dout, out, lse, 0.125,
                               form="cuda")
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="K11.*head width 32"):
        rpe.rpe_self_attention(q, k, v, qp, emb, masks, qw, pts, scale=0.125).sum().backward()
    torch.cuda.synchronize()
    assert rpe.rpe_attention_bwd.launches == before


def test_rpe_attention_bwd_tc_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory plan of K11's tc form is the kernel's."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    fn = getattr(_build._library("rpe_attention_bwd"), "se3et_rpe_attention_bwd_tc_smem")
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    for ah, hc, cc in ((24, 64, 256), (4, 64, 256), (24, 16, 64), (24, 64, 128), (8, 64, 256)):
        assert fn(ah, hc, cc) == rpe.bwd_tc_smem_bytes(ah, hc, cc)
    assert fn(24, 64, 256) > 0 and fn(4, 64, 256) > 0 and fn(24, 64, 128) == 0


@pytest.mark.parametrize("n,pad", RPE_EDGES)
@pytest.mark.parametrize("ah,with_sh", [(24, True), (4, False)])
def test_rpe_attention_row_stats_leave_the_output_unchanged(cuda, ah, with_sh, n, pad):
    """K5 with and without its row log-sum-exp output gives the same out
    (bit for bit), and the log-sum-exp agrees with the plain version's."""
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    points, masks = _cloud(cuda, n, 4, pad=pad)
    g = torch.Generator().manual_seed(11)
    b, n = masks.shape
    rnd = lambda *s: torch.randn(s, generator=g).to(cuda, torch.bfloat16)  # noqa: E731
    q, k, v, qp, emb = rnd(b, ah, n, 64), rnd(b, ah, n, 64), rnd(b, ah, n, 64), \
        rnd(b, n, ah, 256) * 0.0625, rnd(b, n, n, 256)
    qw = (torch.randn((b, 3, ah, n), generator=g) * 0.3).to(cuda) if with_sh else None
    pts = rpe.point_rows(points) if with_sh else None
    plain = rpe.rpe_self_attention(q, k, v, qp, emb, masks, qw, pts, scale=0.125)
    out, lse = rpe.rpe_self_attention_with_lse(q, k, v, qp, emb, masks, qw, pts, scale=0.125)
    assert torch.equal(plain, out)
    _, want = rpe.rpe_self_attention_plain(q, k, v, qp, emb, masks, qw, pts, scale=0.125,
                                           with_lse=True)
    assert float((lse - want).abs().max()) <= 1e-3 * float(want.abs().max())


def _conv_neighbors(cuda, nq, ns, h, seed):
    """Two clouds of local neighbour rows (about a quarter sentinels) with
    the last 3 query rows all sentinels, as the pyramid's padded rows."""
    g = torch.Generator().manual_seed(seed)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    nbr[:, -3:] = ns
    return nbr


@pytest.mark.parametrize("nq,ns,h,ac,ac_out", [
    (20000, 20000, 24, 192, 192),   # stage-0 bottleneck conv
    (10000, 10000, 32, 384, 384),   # stage-1 bottleneck convs
    (9000, 9000, 32, 384, 384),     # a partial half tile in the last wave
    (1003, 2000, 24, 192, 384),     # Nq not a multiple of the 64-row tile
    (997, 2000, 32, 384, 192),
    (500, 1000, 38, 192, 192),      # H > 32: the CUDA-core gather
    (250, 997, 7, 48, 48),          # ragged, tiny widths
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_wf_mm_kernel(cuda, nq, ns, h, ac, ac_out, dtype):
    """K12 with about a quarter sentinel neighbours and the last 3 query
    rows of each cloud all sentinels."""
    nbr = _conv_neighbors(cuda, nq, ns, h, 12)
    _assert_ok(selfcheck.check_fused_conv("gather_wf_mm", nbr, ns, ac, ac_out=ac_out,
                                          dtype=dtype, reps=1))


@pytest.mark.parametrize("k,ac,ac_out", [(15, 192, 192), (15, 384, 384), (3, 40, 16)])
def test_gather_wf_mm_panels_kernel(cuda, k, ac, ac_out):
    """K12's weight relayout on the card equals its plain version."""
    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(20)
    rhs = torch.randn((ac_out, k * ac), generator=g).to(cuda, torch.bfloat16).t()
    want = wc.mm_panels(rhs, k, ac)
    got = torch.empty_like(want)
    _build.check(_build.function("gather_wf_mm", "se3et_gather_wf_mm_panels_bf16", 2, 3)(
        rhs.t().contiguous().data_ptr(), got.data_ptr(), k, ac, ac_out,
        torch.cuda.current_stream().cuda_stream), "panels")
    assert torch.equal(got, want)


def test_gather_wf_mm_reads_padded_influence_in_place(cuda):
    """K12 in bf16 reads the first H of H' > H influence columns as they lie
    (the padded host layout), equal to the plain version on the same
    tensor, and to itself on the unpadded copy."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    g = torch.Generator().manual_seed(19)
    nq, ns, h = 1003, 2000, 24
    nbr = _conv_neighbors(cuda, nq, ns, h, 19)
    x = torch.randn((2, ns, 192), generator=g).to(cuda, torch.bfloat16)
    infl = torch.rand((2, nq, h + 8, 15), generator=g).to(cuda, torch.bfloat16)
    infl[:, :, :h] *= (nbr < ns)[..., None]
    rhs = (torch.randn((192, 15 * 192), generator=g) * 0.02).to(cuda, torch.bfloat16).t()
    got = wc.gather_wf_mm(x, nbr, infl, rhs)
    want = wc.gather_wf_mm_plain(x, nbr, infl, rhs)
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())
    assert torch.equal(got, wc.gather_wf_mm(x, nbr, infl[:, :, :h].contiguous(), rhs))


@pytest.mark.parametrize("nq,ns,h,ac,ac2", [
    (10000, 20000, 24, 192, 768),   # s0 -> s1 strided bottleneck
    (97, 250, 5, 48, 192),          # ragged, tiny widths
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_wf_max_mm_kernel(cuda, nq, ns, h, ac, ac2, dtype):
    nbr = _conv_neighbors(cuda, nq, ns, h, 13)
    _assert_ok(selfcheck.check_fused_conv("gather_wf_max_mm", nbr, ns, ac, ac_out=ac,
                                          ac2=ac2, dtype=dtype, reps=1))


def _k13_inputs(cuda, nbr, ns, ac, ac_out, ac2, k, seed, negative=False):
    """x, influence (zero on sentinels), the expanded weight as the model
    builds it (a transposed view) and the skip payload, bf16; with
    ``negative`` every payload value is below zero, so that a sentinel's
    zero row sets the max."""
    g = torch.Generator().manual_seed(seed)
    b, nq, h = nbr.shape
    x = torch.randn((b, ns, ac), generator=g).to(cuda, torch.bfloat16)
    infl = (torch.rand((b, nq, h, k), generator=g).to(cuda)
            * (nbr < ns)[..., None]).to(torch.bfloat16)
    rhs = (torch.randn((ac_out, k * ac), generator=g) * (k * ac) ** -0.5).to(
        cuda, torch.bfloat16).t()
    x2 = torch.randn((b, ns, ac2), generator=g)
    if negative:
        x2 = -x2.abs() - 0.01
    return x, infl, rhs, x2.to(cuda, torch.bfloat16)


@pytest.fixture(scope="module")
def pair_subsampling():
    """Pair 0's s0 -> s1 neighbour rows (2, 10000, 24) over 20000 points, as
    chip_smoke.py builds them (synthetic se3ete.3dmatch pair, host
    pipeline)."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    pair = synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)
    return torch.as_tensor(pair["subsampling_0"]).to(torch.int32), pair["points_0"].shape[1]


def _k13_neighbors(cuda, pattern, nq, ns, h, seed, pair):
    """(2, nq, h) neighbour rows: "local" (about a quarter sentinels, the
    last 3 rows all sentinels), "dense" (no sentinel), "pad" (local, with
    rows 64-191 of each cloud, whole tiles, all sentinels), "empty" (every
    slot a sentinel) or "pair" (pair 0's s0 -> s1 rows, their first nq
    rows and h columns)."""
    if pattern == "pair":
        nbr, pair_ns = pair
        assert ns == pair_ns
        return nbr[:, :nq, :h].contiguous().to(cuda)
    g = torch.Generator().manual_seed(seed)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    if pattern == "dense":
        q = torch.arange(nq, device=cuda)[:, None] * ns // nq
        return (q + torch.arange(h, device=cuda)).clamp(0, ns - 1).to(torch.int32).expand(
            2, nq, h).contiguous()
    if pattern == "pad":
        nbr[:, 64:192] = ns
    if pattern == "empty":
        nbr[:] = ns
    nbr[:, -3:] = ns
    return nbr


@pytest.mark.parametrize("nq,ns,h,ac,ac_out,ac2,k,pattern", [
    (10000, 20000, 24, 192, 192, 768, 15, "pair"),   # the serving shape
    (10000, 20000, 24, 192, 192, 768, 15, "local"),
    (10000, 20000, 24, 192, 192, 768, 15, "pad"),    # whole tiles of padding
    (10000, 20000, 24, 192, 192, 1536, 15, "pair"),  # the widest payload: 2 slots
    (1, 50, 1, 48, 8, 8, 1, "local"),
    (63, 500, 8, 64, 64, 96, 16, "dense"),           # no sentinel: no zero in the max
    (64, 500, 16, 64, 192, 768, 15, "local"),
    (97, 500, 17, 192, 64, 1536, 15, "dense"),
    (97, 500, 24, 40, 8, 96, 1, "local"),
    (97, 500, 32, 192, 192, 768, 16, "local"),
    (1000, 3000, 32, 96, 192, 8, 15, "pad"),
    (1000, 3000, 8, 192, 192, 768, 15, "empty"),     # every tile padding
    (9000, 18000, 24, 192, 192, 768, 15, "local"),   # a partial half tile last
    (10000, 20000, 24, 192, 192, 100, 15, "local"),  # AC2 not of 16-byte units: "first"
    (1000, 3000, 16, 192, 192, 1544, 15, "local"),   # AC2 past 1536: "first"
])
@pytest.mark.parametrize("negative", [False, True])
def test_gather_wf_max_mm_tc_edges(cuda, pair_subsampling, nq, ns, h, ac, ac_out, ac2, k,
                                   pattern, negative):
    """K13 in bf16 against its plain version: pooled bit for bit, the conv
    within 1e-2 of its scale (as selfcheck.check_fused_conv), at ragged Nq
    (1, 63, 64, 97, a half-tile tail), H 1-32, K 1/15/16, A*Cout 8-192 and
    payloads of 8-1536 channels, with rows and whole tiles of sentinels,
    rows without one, and payloads below zero (the sentinel's zero row
    then sets the max).  The payloads the tc form refuses take the first
    design by the form, not by a failure."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    tc = ac2 % 8 == 0 and ac2 <= wc.MAX_SKIP_AC
    assert wc.gather_wf_max_mm_form(h, torch.bfloat16, ac2) == ("tc" if tc else "first")
    nbr = _k13_neighbors(cuda, pattern, nq, ns, h, 23, pair_subsampling)
    x, infl, rhs, x2 = _k13_inputs(cuda, nbr, ns, ac, ac_out, ac2, k, 24, negative)
    with torch.no_grad():
        out, pooled = wc.gather_wf_max_mm(x, nbr, infl, x2, rhs)
        want, want_pooled = wc.gather_wf_max_mm_plain(x, nbr, infl, x2, rhs)
    assert torch.equal(pooled, want_pooled)
    scale = max(float(want.abs().max()), 1e-30)
    assert float((out - want).abs().max()) <= 1e-2 * scale
    if pattern == "empty":
        assert not bool(out.any()) and not bool(pooled.any())


@pytest.mark.parametrize("nq,ns,h,ac2,pattern", [
    (10000, 20000, 24, 768, "pair"),
    (10000, 20000, 24, 768, "pad"),
    (9000, 18000, 32, 1536, "local"),
    (97, 500, 17, 96, "dense"),
])
def test_gather_wf_max_mm_tc_matches_k12(cuda, pair_subsampling, nq, ns, h, ac2, pattern):
    """K13's tc form runs K12's tc gather and product unchanged, so its conv
    equals K12's on the same inputs bit for bit (padding tiles, which K13
    leaves without a product, give zero rows in both)."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr = _k13_neighbors(cuda, pattern, nq, ns, h, 25, pair_subsampling)
    x, infl, rhs, x2 = _k13_inputs(cuda, nbr, ns, 192, 192, ac2, 15, 26)
    with torch.no_grad():
        out, _ = wc.gather_wf_max_mm(x, nbr, infl, x2, rhs)
        assert torch.equal(out, wc.gather_wf_mm(x, nbr, infl, rhs))


@pytest.mark.parametrize("nq,ns,h,ac,ac2", [
    (2500, 10000, 32, 384, 1536),   # s1 -> s2 strided bottleneck
    (20000, 20000, 24, 192, 768),   # stage-0 widths
    (97, 250, 5, 48, 96),           # ragged, tiny widths
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_wf_max_kernel(cuda, nq, ns, h, ac, ac2, dtype):
    nbr = _conv_neighbors(cuda, nq, ns, h, 14)
    _assert_ok(selfcheck.check_fused_conv("gather_wf_max", nbr, ns, ac, ac2=ac2,
                                          dtype=dtype, reps=1))


@pytest.fixture(scope="module")
def pair_subsampling_1():
    """Pair 0's s1 -> s2 neighbour rows (2, 2500, 32) over 10000 points, as
    chip_smoke.py builds them."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, synthetic_extent

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    pair = synthetic_pair(0, cfg.pipeline, None, cfg.data.point_limit,
                          synthetic_extent(cfg.data.dataset), seed=cfg.seed)
    return torch.as_tensor(pair["subsampling_1"]).to(torch.int32), pair["points_1"].shape[1]


def _k14_inputs(cuda, nbr, ns, ac, ac2, k, seed, payload="normal", hs=None):
    """x, influence (zero on sentinels; ``hs`` >= H columns, those past H
    random) and the skip payload, bf16.  ``payload`` "negative": every
    value below zero (a sentinel's zero row sets the max); "zeros": values
    below zero with -0.0 in half the channels of the first rows, where a
    sentinel's +0.0 must win."""
    g = torch.Generator().manual_seed(seed)
    b, nq, h = nbr.shape
    x = torch.randn((b, ns, ac), generator=g).to(cuda, torch.bfloat16)
    infl = torch.rand((b, nq, hs or h, k), generator=g).to(cuda)
    infl[:, :, :h] *= (nbr < ns)[..., None]
    x2 = torch.randn((b, ns, ac2), generator=g)
    if payload != "normal":
        x2 = -x2.abs() - 0.01
    if payload == "zeros":
        x2[:, :ns // 4, 0::2] = -0.0
    return x, infl.to(torch.bfloat16), x2.to(cuda, torch.bfloat16)


def _k14_neighbors(cuda, pattern, nq, ns, h, seed, pair):
    """(2, nq, h) neighbour rows: "pair" (pair 0's s1 -> s2 rows), "local"
    (about a quarter sentinels, rows 5-9 without one, the last 3 all
    sentinels) or "dense" (no sentinel)."""
    if pattern == "pair":
        nbr, pair_ns = pair
        assert (nq, ns, h) == (nbr.shape[1], pair_ns, nbr.shape[2])
        return nbr.to(cuda)
    if pattern == "dense":
        q = torch.arange(nq, device=cuda)[:, None] * ns // nq
        return (q + torch.arange(h, device=cuda)).clamp(0, ns - 1).to(torch.int32).expand(
            2, nq, h).contiguous()
    return _k2_neighbors(cuda, nq, ns, h, seed)


K14_TC_SHAPES = [
    (2500, 10000, 32, 384, 1536, 15, "pair"),    # the serving shape (s1 -> s2)
    (2500, 10000, 32, 384, 1536, 15, "local"),
    (10000, 20000, 24, 192, 768, 15, "local"),   # stage-0 widths
    (20000, 20000, 24, 192, 768, 15, "dense"),
    (1, 50, 5, 8, 8, 1, "local"),                # one row, one unit of each
    (7, 50, 5, 40, 24, 3, "local"),              # fewer items than one warp's share
    (97, 500, 16, 48, 96, 16, "local"),          # HS 1, K 16
    (97, 500, 17, 200, 800, 15, "dense"),        # HS 2, SU 2, chunks ragged
    (1003, 2000, 33, 384, 1536, 15, "local"),    # HS 3
    (1003, 2000, 48, 776, 1528, 15, "local"),    # AC past the chunks, SU 3 uneven
    (999, 3000, 64, 384, 1536, 15, "local"),     # HS 4, the widest tc H
]


@pytest.mark.parametrize("nq,ns,h,ac,ac2,k,pattern", K14_TC_SHAPES)
@pytest.mark.parametrize("payload", ["normal", "negative"])
def test_gather_wf_max_tc_kernel(cuda, pair_subsampling_1, nq, ns, h, ac, ac2, k, pattern,
                                 payload):
    """K14's tc form against its plain version: pooled bit for bit, wf
    within 1e-2 of its scale (as selfcheck.check_fused_conv), at the
    serving shape on pair 0 and on local neighbours, at the stage-0 widths
    and at ragged ones (Nq 1-1003, H 5-64, K 1-16, AC 8-776, AC2 8-1536),
    with payloads below zero, where a sentinel's zero row sets the max."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    assert wc.gather_wf_max_form(h, torch.bfloat16, ac, ac2) == "tc"
    nbr = _k14_neighbors(cuda, pattern, nq, ns, h, 31, pair_subsampling_1)
    x, infl, x2 = _k14_inputs(cuda, nbr, ns, ac, ac2, k, 32, payload)
    with torch.no_grad():
        wf, pooled = wc.gather_wf_max(x, nbr, infl, x2)
        want_wf, want_pooled = wc.gather_wf_max_plain(x, nbr, infl, x2)
    assert torch.equal(pooled, want_pooled)
    scale = max(float(want_wf.float().abs().max()), 1e-30)
    assert float((wf.float() - want_wf.float()).abs().max()) <= 1e-2 * scale
    if pattern == "local":
        assert not bool(wf[:, -3:].any()) and not bool(pooled[:, -3:].any())


@pytest.mark.parametrize("nq,ns,h,ac,ac2,k,pattern", K14_TC_SHAPES)
def test_gather_wf_max_tc_equals_k1_and_k2(cuda, pair_subsampling_1, nq, ns, h, ac, ac2, k,
                                           pattern):
    """K14's tc form takes K1's tensor-core routine and K2's skip routine,
    so its wf is K1's (tc form) and its pooled K2's bit for bit, -0.0 and
    +0.0 included (a payload below zero with -0.0 beside sentinels), the
    influence read in place from H' = H + 3 columns."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    assert wc.gather_wf_form(h, torch.bfloat16, k, ac) == "tc"
    nbr = _k14_neighbors(cuda, pattern, nq, ns, h, 33, pair_subsampling_1)
    x, infl, x2 = _k14_inputs(cuda, nbr, ns, ac, ac2, k, 34, "zeros", hs=h + 3)
    with torch.no_grad():
        wf, pooled = wc.gather_wf_max(x, nbr, infl, x2)
        assert torch.equal(_bits(wf), _bits(wc.gather_wf(x, nbr, infl)))
        assert torch.equal(_bits(pooled), _bits(wc.neighbor_max(x2, nbr)))


def test_gather_wf_max_tc_raises_on_misaligned_rows(cuda):
    """The tc form reads 16-byte units: x or x2 starting off a 16-byte
    boundary raises instead of running another form."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    def off_by_one(*shape):  # contiguous, one element past an aligned start
        n = shape[0] * shape[1] * shape[2]
        return torch.randn(n + 1, device=cuda).to(torch.bfloat16)[1:].view(shape)

    nbr = _conv_neighbors(cuda, 64, 128, 5, 35)
    x, x2 = off_by_one(2, 128, 48), off_by_one(2, 128, 96)
    assert x.is_contiguous() and x.data_ptr() % 16 and x2.data_ptr() % 16
    infl = torch.rand((2, 64, 5, 15), device=cuda).to(torch.bfloat16)
    assert wc.gather_wf_max_form(5, torch.bfloat16, 48, 96) == "tc"
    with torch.no_grad():
        with pytest.raises(ValueError, match="16-byte aligned"):
            wc.gather_wf_max(x, nbr, infl, x2.clone())
        with pytest.raises(ValueError, match="16-byte aligned"):
            wc.gather_wf_max(x.clone(), nbr, infl, x2)


def test_gather_wf_max_plan_matches_the_kernel(cuda):
    """The wrapper's plan (form, HS, chunks, SU, slices, NB) is the C entry
    point's, at every H up to 66, and at the AC and AC2 widths up to 1600 in
    both dtypes."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    fn = _build._library("gather_wf_max").se3et_gather_wf_max_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    codes = {code: name for name, code in wc.GATHER_WF_MAX_FORMS.items()}
    shapes = [(h, 384, 1536) for h in range(1, 67)]
    shapes += [(32, ac, ac2) for ac in (1, 7, 8, 40, 384, 776) for ac2 in range(1, 1601)]
    for dtype, nbytes in ((torch.bfloat16, 2), (torch.float32, 4)):
        for h, ac, ac2 in shapes:
            out = (ctypes.c_int * 6)()
            form = fn(h, ac, ac2, nbytes, out)
            assert (codes[form], *out[1:]) == tuple(wc.gather_wf_max_plan(h, dtype, ac, ac2)), \
                (h, ac, ac2, dtype)


def test_fused_conv_kernels_raise_on_grad_and_refused_widths(cuda):
    """No fallback: an input that requires grad raises, and widths outside
    the gates raise instead of running anything else."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    nbr = _conv_neighbors(cuda, 64, 128, 5, 15)
    x = torch.randn((2, 128, 48), device=cuda, dtype=torch.bfloat16)
    infl = torch.rand((2, 64, 5, 15), device=cuda, dtype=torch.bfloat16)
    rhs = torch.randn((15 * 48, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no backward"):
        wc.gather_wf_mm(x.clone().requires_grad_(True), nbr, infl, rhs)
    with pytest.raises(ValueError, match="does not take"):
        wc.gather_wf_mm(x, nbr, infl, torch.zeros((15 * 48, 392), device=cuda,
                                                  dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="does not take"):
        wc.gather_wf_max(x, nbr, infl, torch.zeros((2, 128, 3072), device=cuda,
                                                   dtype=torch.bfloat16))


@pytest.mark.parametrize("nq,ns,h", [
    (20000, 20000, 24),   # stage-0 same-level set
    (10000, 20000, 24),   # stage-1 strided set
    (1024, 2500, 38),     # stage-3 strided set
    (97, 250, 5),         # ragged, tiny
])
@pytest.mark.parametrize("mode", ["linear", "constant", "gaussian"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_influence_kernel(cuda, nq, ns, h, mode, out_dtype):
    """K15 with sentinels (about a quarter, and the last 3 query rows all
    sentinels) in the three influence modes."""
    from se3et_tpu_torch.core import kernel_points as kp_lib

    g = torch.Generator().manual_seed(16)
    s_points = (torch.rand((2, ns, 3), generator=g) * 2).to(cuda)
    q_points = s_points[:, :nq].contiguous()
    nbr = _conv_neighbors(cuda, nq, ns, h, 17)
    kp = kp_lib.equivariant_kernel_points(0.0625, 15, 6, 4)
    _assert_ok(selfcheck.check_influence(q_points, s_points, nbr, kp, 0.05, mode=mode,
                                         out_dtype=out_dtype, reps=1))


# the seven (stage, neighbour set) shapes of a device-influence pair
# (Nq, Ns, H): the stage-0 same-level set, s0 -> s1, stage 1, s1 -> s2,
# stage 2, s2 -> s3, stage 3
INFLUENCE_SETS = [(20000, 20000, 24), (10000, 20000, 24), (10000, 10000, 32), (2500, 10000, 32),
                  (2500, 2500, 36), (1024, 2500, 36), (1024, 1024, 38)]


def _influence_inputs(cuda, nq, ns, h, seed, k=15):
    """Points in a cube of 0.15 (the neighbours' offsets reach the kernel
    points' 0.0625 radius, so most weights are neither 0 nor 1), local
    neighbour rows (a quarter sentinels, the last 3 rows all sentinels) and
    K kernel points."""
    from se3et_tpu_torch.core import kernel_points as kp_lib

    g = torch.Generator().manual_seed(seed)
    s_points = (torch.rand((2, ns, 3), generator=g) * 0.15).to(cuda)
    q_points = (torch.rand((2, nq, 3), generator=g) * 0.15).to(cuda)
    nbr = _conv_neighbors(cuda, nq, ns, h, seed + 1)
    kp = kp_lib.equivariant_kernel_points(0.0625, 15, 6, 4)[:k] if k <= 15 else \
        torch.rand((k, 3), generator=g).numpy() * 0.1 - 0.05
    return q_points, s_points, nbr, kp


def _assert_tiles_ok(res):
    _assert_ok(res)
    assert res.form == "tiles" and res.bitwise, (res.shape, res.form, res.bitwise)


@pytest.mark.parametrize("nq,ns,h", INFLUENCE_SETS)
@pytest.mark.parametrize("mode", ["linear", "constant", "gaussian"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_influence_tiles_kernel(cuda, nq, ns, h, mode, out_dtype):
    """K15's tiles form at the seven sets of a pair: within tolerance of the
    plain version, and both outputs bit for bit the first design's (and a
    second call's)."""
    q_points, s_points, nbr, kp = _influence_inputs(cuda, nq, ns, h, 18)
    _assert_tiles_ok(selfcheck.check_influence(q_points, s_points, nbr, kp, 0.05, mode=mode,
                                               out_dtype=out_dtype, reps=1, first=True))


@pytest.mark.parametrize("nq,ns,h,k", [
    (1003, 2000, 24, 15),   # Nq not a multiple of the 16-row tile
    (5, 50, 24, 15),        # Nq below a tile: one partial tile over both clouds
    (1003, 2000, 1, 15),    # H 1
    (300, 2000, 64, 15),    # H at the form's limit: 1024 threads, 60 KB staged
    (1003, 2000, 24, 1),    # K 1 and 16
    (1003, 2000, 24, 16),
    (97, 250, 5, 3),        # spans that end inside a 16-byte unit
    (100, 1, 24, 15),       # Ns 1
])
@pytest.mark.parametrize("mode", ["linear", "constant", "gaussian"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_influence_tiles_kernel_edges(cuda, nq, ns, h, k, mode, out_dtype):
    """K15's tiles form at ragged shapes, bit for bit the first design's."""
    q_points, s_points, nbr, kp = _influence_inputs(cuda, nq, ns, h, 19, k=k)
    if ns == 1:  # every slot 0 or the sentinel 1
        nbr = (nbr % 2).to(torch.int32)
    _assert_tiles_ok(selfcheck.check_influence(q_points, s_points, nbr, kp, 0.05, mode=mode,
                                               out_dtype=out_dtype, reps=1, first=True))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_influence_tiles_all_sentinel_rows_and_refusals(cuda, out_dtype):
    """All-sentinel rows (and negative indices) give zero weights and sums
    in both forms; the tiles form refuses H 65, which the first design
    takes; no kernel takes K 17."""
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    q_points, s_points, nbr, kp = _influence_inputs(cuda, 1003, 2000, 24, 20)
    nbr = torch.where(torch.arange(24, device=cuda) % 2 == 0, 2000, -1).expand(2, 1003, 24)
    for form in ("tiles", "first"):
        infl, inf_sum = wc.influence(q_points, s_points, nbr, torch.as_tensor(kp, device=cuda),
                                     sigma=0.05, out_dtype=out_dtype, form=form)
        assert not infl.any() and not inf_sum.any()
        assert not _bits(infl).any() and not _bits(inf_sum).any()  # +0.0, not -0.0
    q_points, s_points, nbr, kp = _influence_inputs(cuda, 97, 250, 65, 21)
    assert wc.influence_form(65, 15, out_dtype) == "first"
    _assert_ok(selfcheck.check_influence(q_points, s_points, nbr, kp, 0.05,
                                         out_dtype=out_dtype, reps=1))
    kpt = torch.as_tensor(kp, device=cuda)
    with pytest.raises(ValueError, match="tiles form does not take"):
        wc.influence(q_points, s_points, nbr, kpt, sigma=0.05, out_dtype=out_dtype,
                     form="tiles")
    with pytest.raises(ValueError, match="no K15 kernel"):
        wc.influence(q_points, s_points, nbr[..., :24], torch.zeros((17, 3), device=cuda),
                     sigma=0.05, out_dtype=out_dtype)


def test_influence_plan_matches_the_kernel(cuda):
    """The wrapper's plan (form, rows, threads, staging bytes) is the C entry
    point's, at H 0-66 and K 0-17."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    fn = _build._library("influence").se3et_influence_plan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for h in range(67):
        for k in range(18):
            out = (ctypes.c_int * 3)()
            form = fn(h, k, out)
            assert ({1: "tiles", 0: "first"}[form], *out) == tuple(wc.influence_plan(h, k)), \
                (h, k)


# runs of masked keys inside key tiles (cloud, first key, end): inside one
# tile, up to a tile's end, across a tile boundary, a single key
FEMB_MASK_RUNS = ((0, 37, 45), (1, 100, 128), (0, 500, 532), (1, 70, 71))


@pytest.mark.parametrize("n,ah,c,cc,with_sh,dtype,pad,runs", [
    (1024, 24, 64, 256, True, torch.bfloat16, 40, False),    # self_eq layers
    (1024, 4, 64, 256, False, torch.bfloat16, 40, False),    # plain self layers
    (1024, 24, 64, 256, False, torch.bfloat16, 40, False),
    (1024, 4, 64, 256, True, torch.bfloat16, 40, False),
    (1003, 24, 64, 256, True, torch.bfloat16, 40, False),    # ragged N
    (128, 24, 16, 64, True, torch.float32, 40, False),       # tiny card-vs-CPU widths
    (128, 4, 16, 64, False, torch.float32, 40, False),
    (128, 24, 64, 64, True, torch.float32, 40, False),       # float32 at the serving head width
    (1000, 24, 64, 256, True, torch.bfloat16, 8, False),     # N not a multiple of the key
    (1000, 4, 64, 256, False, torch.bfloat16, 8, False),     # tile, its last tile masked
    (1000, 24, 64, 256, True, torch.bfloat16, 72, False),    # the last two tiles masked
    (1024, 24, 64, 256, True, torch.bfloat16, 40, True),     # masked runs inside tiles
    (1024, 4, 64, 256, False, torch.bfloat16, 40, True),
    (12, 24, 64, 256, True, torch.bfloat16, 3, False),       # fewer rows than positional
    (12, 4, 64, 256, False, torch.bfloat16, 3, False),       # warps (AH = 4: 8 of them)
    # head width 32 (the wide-head family, C = 128): the CUDA-core form
    (1024, 24, 32, 128, True, torch.bfloat16, 40, False),    # se3ete2 self_eq layers
    (1024, 4, 32, 128, False, torch.bfloat16, 40, False),    # its plain self layers
    (1003, 24, 32, 128, True, torch.bfloat16, 72, False),    # ragged, masked tiles
    (1024, 24, 32, 128, True, torch.bfloat16, 40, True),     # masked runs inside tiles
    (128, 24, 32, 128, True, torch.float32, 40, False),      # float32
    (128, 4, 32, 128, False, torch.float32, 40, False),
])
def test_rpe_attention_femb_kernel(cuda, n, ah, c, cc, with_sh, dtype, pad, runs):
    points, masks = _cloud(cuda, n, 18, pad=pad)
    if runs:
        for cloud, m0, m1 in FEMB_MASK_RUNS:
            masks[cloud, m0:m1] = False
    _assert_ok(selfcheck.check_rpe_attention_femb(points, masks, ah, c=c, cc=cc,
                                                  with_sh=with_sh, dtype=dtype, reps=1))


def test_rpe_attention_femb_ws_plan_matches_the_kernel(cuda):
    """The wrapper's shared-memory plan of K16's ws form is the kernel's."""
    import ctypes

    from se3et_tpu_torch.ops.kernels import _build
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    fn = getattr(_build._library("rpe_attention_femb"), "se3et_rpe_attention_femb_ws_smem")
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    for ah, hc, cc in ((24, 64, 256), (4, 64, 256), (24, 64, 64), (4, 64, 512)):
        assert fn(ah, hc, cc) == rpe.femb_ws_smem_bytes(ah, hc, cc)
    assert fn(24, 16, 64) == 0 and fn(24, 64, 48) == 0
