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
from se3et_tpu_torch.ops.kernels import eq_attention as eq_k
from se3et_tpu_torch.ops.kernels import rpe_attention as rpe_k
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


@pytest.mark.parametrize("h,dtype,k,ac,form", [
    (1, torch.bfloat16, 15, 192, "tc"), (36, torch.bfloat16, 15, 768, "tc"),
    (64, torch.bfloat16, 15, 192, "tc"), (65, torch.bfloat16, 15, 192, "first"),
    (24, torch.float32, 15, 192, "rows"), (38, torch.float32, 15, 1536, "rows"),
    (1, torch.float32, 1, 4, "rows"), (64, torch.float32, 16, 44, "rows"),
    (65, torch.float32, 15, 192, "first"), (24, torch.float32, 15, 6, "first"),
    (24, torch.float32, 17, 192, "first"),
])
def test_gather_wf_form(h, dtype, k, ac, form):
    """K1 takes the tensor-core form in bf16 up to H = 64, the rows form in
    float32 up to H = 64 and K = 16 with AC a multiple of 4 (every training
    conv), else the first design."""
    assert wc_k.gather_wf_form(h, dtype, k, ac) == form


@pytest.mark.parametrize("ac,slices,width", [
    (4, 1, 1), (12, 1, 3), (192, 2, 24), (768, 6, 32), (1536, 12, 32), (776, 7, 28),
])
def test_gather_wf_rows_plan_covers_the_row(ac, slices, width):
    """The rows form's slices cover every 16-byte unit (4 channels) of a row
    exactly once: slice s gives lane l the unit s * width + l, for the
    lanes below the slice's width and the units below the row's; a slice is
    one warp's 32 lanes at most, and the slices are balanced (the last one
    holds more than all but one lane's share)."""
    plan = wc_k.gather_wf_rows_plan(24, 15, ac)
    assert plan == ("rows", slices, width)
    units = ac // 4
    seen = np.zeros(units, int)
    for s in range(plan.slices):
        for lane in range(32):
            u = s * plan.width + lane
            if lane < plan.width and u < units:
                seen[u] += 1
    assert (seen == 1).all()
    assert plan.width <= 32 and units - (plan.slices - 1) * plan.width > plan.width - plan.slices


@pytest.mark.parametrize("h,k,form", [
    (24, 15, "tiles"), (32, 15, "tiles"), (36, 15, "tiles"), (38, 15, "tiles"),  # the sets
    (1, 1, "tiles"), (64, 16, "tiles"), (65, 15, "first"), (256, 15, "first"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_influence_form(h, k, form, dtype):
    """K15 takes the tiles form up to H = 64 and K = 16 (every set of a
    pair: H 24, 32, 36, 38), the first design past H = 64, in both dtypes."""
    assert wc_k.influence_form(h, k, dtype) == form


@pytest.mark.parametrize("h,k,dtype,error", [
    (24, 17, torch.bfloat16, ValueError), (24, 0, torch.float32, ValueError),
    (257, 15, torch.float32, ValueError), (0, 15, torch.bfloat16, ValueError),
    (24, 15, torch.float16, TypeError),
])
def test_influence_form_refuses_shapes_no_kernel_takes(h, k, dtype, error):
    with pytest.raises(error):
        wc_k.influence_form(h, k, dtype)


@pytest.mark.parametrize("h", range(1, 65))
def test_influence_tiles_plan_fits(h):
    """The tiles plan at every H it takes (K 1-16): R a multiple of 8, so a
    tile's span of either output starts 16-byte aligned in either dtype;
    one thread a slot in whole warps (none idle where R * H is a multiple
    of 32: every set of a pair) within a block of 1024; the staging tile
    and the list of valid slots within an H100 block's 232,448 bytes of
    shared memory."""
    for k in range(1, 17):
        plan = wc_k.influence_plan(h, k)
        assert plan.form == "tiles" and plan.rows % 8 == 0
        for esize in (2, 4):
            assert (plan.rows * h * k * esize) % 16 == 0
        assert (plan.rows * k * 4) % 16 == 0
        slots = plan.rows * h
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.threads == -(-slots // 32) * 32
        assert plan.smem_bytes == slots * (k * 4 + 8) <= 232448
    if h in (24, 32, 36, 38):
        assert wc_k.influence_plan(h, 15).threads == wc_k.INFLUENCE_TILES_ROWS * h


def test_influence_padded_outputs():
    """The tiles form's outputs: contiguous views of the requested shape over
    an allocation that runs on to a whole 16-byte unit."""
    for shape, dtype in (((2, 97, 5, 3), torch.bfloat16), ((2, 97, 3), torch.float32),
                         ((2, 20000, 24, 15), torch.bfloat16)):
        t = wc_k._padded_empty(shape, dtype, "cpu")
        assert t.shape == shape and t.is_contiguous() and t.storage_offset() == 0
        assert t.untyped_storage().nbytes() % 16 == 0
        assert 0 <= t.untyped_storage().nbytes() - t.numel() * t.element_size() < 16


def _bad_influence_inputs():
    q = torch.zeros((2, 7, 3))
    s = torch.zeros((2, 9, 3))
    nbr = torch.zeros((2, 7, 4), dtype=torch.int32)
    kp = torch.zeros((15, 3))
    return {
        "out_dtype float16": ((q, s, nbr, kp), dict(out_dtype=torch.float16), TypeError),
        "K 17": ((q, s, nbr, torch.zeros((17, 3))), {}, ValueError),
        "kernel points (15, 2)": ((q, s, nbr, torch.zeros((15, 2))), {}, ValueError),
        "q of other rows": ((q[:, :6], s, nbr, kp), {}, ValueError),
        "s of another batch": ((q, s[:1], nbr, kp), {}, ValueError),
        "s of 2 coordinates": ((q, s[..., :2], nbr, kp), {}, ValueError),
        "nbr of 2 dimensions": ((q, s, nbr[0], kp), {}, ValueError),
        "float nbr": ((q, s, nbr.float(), kp), {}, ValueError),
        "no source points": ((q, s[:, :0], nbr, kp), {}, ValueError),
        "H 0": ((q, s, nbr[..., :0], kp), {}, ValueError),
        "unknown mode": ((q, s, nbr, kp), dict(mode="cubic"), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_influence_inputs()))
def test_influence_checks_its_inputs_on_the_cpu(case):
    """K15's wrapper refuses what no kernel takes on every device: on the
    CPU too, before its plain version runs."""
    args, kw, error = _bad_influence_inputs()[case]
    with pytest.raises(error):
        wc_k.influence(*args, sigma=0.05, **kw)


@pytest.mark.parametrize("ah,hc,cc,dtype,form", [
    (24, 64, 256, torch.bfloat16, "ws"), (4, 64, 256, torch.bfloat16, "ws"),
    (24, 64, 64, torch.bfloat16, "ws"),
    (24, 64, 256, torch.float32, "cuda"), (4, 64, 256, torch.float32, "cuda"),
    (24, 16, 64, torch.bfloat16, "cuda"), (4, 16, 64, torch.bfloat16, "cuda"),
    (24, 16, 64, torch.float32, "cuda"), (24, 64, 48, torch.bfloat16, "cuda"),
    (24, 32, 128, torch.bfloat16, "cuda"), (4, 32, 128, torch.bfloat16, "cuda"),  # se3ete2
    (24, 32, 128, torch.float32, "cuda"),
])
def test_rpe_attention_form(ah, hc, cc, dtype, form):
    """K5 takes the ws form in bf16 with head width 64 and C % 32 == 0, the
    CUDA-core form otherwise (head width 32, the wide-head family, too)."""
    assert rpe_k.rpe_attention_form(ah, hc, cc, dtype) == form


@pytest.mark.parametrize("ah,hc,cc,form", [(24, 64, 256, "ws"), (4, 64, 256, "ws"),
                                           (24, 16, 64, "cuda"), (24, 32, 128, "cuda")])
def test_rpe_attention_form_of_femb(ah, hc, cc, form):
    """K16 takes its own ws form in bf16 at the serving shapes."""
    assert rpe_k.rpe_attention_form(ah, hc, cc, torch.bfloat16, femb=True) == form


@pytest.mark.parametrize("femb", [False, True])
def test_rpe_attention_forms_are_ws_or_cuda(femb):
    """Every shape a kernel takes goes to "ws" or "cuda": K16's first
    tensor-core form ("tc") is gone."""
    forms = set()
    for ah in rpe_k.KERNEL_AH:
        for hc in rpe_k.KERNEL_HEAD_DIMS:
            for cc in (16, 32, 48, 64, 256, 512):
                for dtype in (torch.bfloat16, torch.float32):
                    try:
                        forms.add(rpe_k.rpe_attention_form(ah, hc, cc, dtype, femb=femb))
                    except ValueError:
                        pass
    assert forms == {"ws", "cuda"}


@pytest.mark.parametrize("ah", [4, 24])
def test_rpe_attention_femb_ws_plan_fits_a_block(ah):
    """K16's ws form at the serving width C = 256 fits one block of an H100
    (232,448 bytes) with G resident and its positional groups' basis rows
    beside K5's score buffers and v tiles: the rest of its plan is smaller
    than K5's ws plan, which holds a ring of embedding slabs."""
    plan = rpe_k.femb_ws_smem_bytes(ah, 64, 256)
    resident = 256 * 72 * 2 + rpe_k.femb_ws_groups(ah) * 32 * 104 * 2
    assert resident < plan <= 232448 == rpe_k.SMEM_LIMIT
    assert plan - resident < rpe_k.ws_smem_bytes(ah, 64, 256)


@pytest.mark.parametrize("ah", [4, 24])
def test_rpe_attention_ws_plan_fits_a_block(ah):
    """The ws form's shared memory at the serving width C = 256 fits one
    block of an H100 (232,448 bytes), with its ring of 16 KB embedding
    slabs and their rows' folded queries."""
    plan = rpe_k.ws_smem_bytes(ah, 64, 256)
    assert rpe_k.ws_slots(ah) * (32 + ah) * 256 * 2 < plan <= 232448 == rpe_k.SMEM_LIMIT


@pytest.mark.parametrize("ah,hc,cc,dtype", [
    (24, 64, 512, torch.bfloat16),   # neither form's plan fits a block
    (8, 64, 256, torch.bfloat16),    # no kernel for AH = 8
    (24, 128, 256, torch.bfloat16),  # nor head width 128
    (24, 64, 40, torch.float32),     # C % 16 != 0
    (24, 64, 256, torch.float16),
])
def test_rpe_attention_form_refuses_shapes_no_kernel_takes(ah, hc, cc, dtype):
    with pytest.raises(ValueError):
        rpe_k.rpe_attention_form(ah, hc, cc, dtype)


@pytest.mark.parametrize("ah,hc,cc,dtype,form", [
    (24, 64, 256, torch.bfloat16, "tc"),    # self_eq layers in training
    (4, 64, 256, torch.bfloat16, "tc"),     # plain self layers in training
    (24, 64, 256, torch.float32, "cuda"), (4, 64, 256, torch.float32, "cuda"),
    (24, 16, 64, torch.bfloat16, "cuda"),   # the tiny card-vs-CPU widths
    (4, 16, 64, torch.float32, "cuda"),
    (24, 64, 128, torch.bfloat16, "cuda"),  # tc is built for C = 256 only
    (4, 64, 512, torch.bfloat16, "cuda"),
])
def test_rpe_attention_bwd_form(ah, hc, cc, dtype, form):
    """K11 takes its tc form in bf16 with head width 64 and C = 256 (the
    training shapes), the first design otherwise."""
    assert rpe_k.rpe_attention_bwd_form(ah, hc, cc, dtype) == form


@pytest.mark.parametrize("ah", [4, 24])
def test_rpe_attention_bwd_tc_plan_fits_a_block(ah):
    """K11's tc plan at C = 256 fits one block of an H100 (232,448 bytes):
    two buffers of 4 rows' 32-key embedding slabs (128 KB) beside the rows'
    resident qp, q and dO, and the tile's score and dS' buffers; the plan is
    0 where the form is not built."""
    plan = rpe_k.bwd_tc_smem_bytes(ah, 64, 256)
    slabs = 2 * rpe_k.BWD_TC_ROWS * rpe_k.BWD_TC_KEYS * 256 * 2
    resident = rpe_k.BWD_TC_ROWS * (-(-ah // 8) * 8) * 256 * 2
    assert slabs + resident < plan <= 232448 == rpe_k.SMEM_LIMIT
    assert rpe_k.bwd_tc_smem_bytes(ah, 64, 128) == rpe_k.bwd_tc_smem_bytes(ah, 16, 256) == 0


@pytest.mark.parametrize("ah,hc,cc,dtype", [
    (24, 64, 512, torch.bfloat16),   # the first design's float32 qp does not fit
    (24, 64, 512, torch.float32),
    (8, 64, 256, torch.bfloat16),    # no kernel for AH = 8
    (24, 32, 256, torch.bfloat16),   # nor head width 32
    (24, 64, 40, torch.float32),     # C % 16 != 0
    (24, 64, 256, torch.float16),
])
def test_rpe_attention_bwd_form_refuses_shapes_no_kernel_takes(ah, hc, cc, dtype):
    with pytest.raises(ValueError):
        rpe_k.rpe_attention_bwd_form(ah, hc, cc, dtype)


@pytest.mark.parametrize("c,dtype,form", [
    (256, torch.bfloat16, "tc"),    # training's embedding (se3ete.3dmatch)
    (128, torch.bfloat16, "tc"),
    (64, torch.bfloat16, "tc"),     # the tiny card-vs-CPU widths in bf16
    (256, torch.float32, "cuda"),   # float32 keeps the first design
    (64, torch.float32, "cuda"),
    (40, torch.float32, "cuda"),
    (192, torch.bfloat16, "cuda"),  # tc is built for 64, 128 and 256 only
    (512, torch.bfloat16, "cuda"),
    (16, torch.bfloat16, "cuda"),
])
def test_geometric_embedding_bwd_form(c, dtype, form):
    """K10 takes its tc form in bf16 at C = 64, 128 and 256, the first
    design otherwise."""
    assert emb_k.geometric_embedding_bwd_form(c, dtype) == form


@pytest.mark.parametrize("c,dtype,bases", [
    (2048, torch.float32, (40, 16, 3)),   # one thread a channel: C <= 1024
    (0, torch.float32, (40, 16, 3)),
    (40, torch.bfloat16, (40, 16, 3)),    # bf16: C % 16 == 0
    (256, torch.float16, (40, 16, 3)),
    (256, torch.bfloat16, (48, 16, 3)),   # the kernels' basis sizes and k are fixed
    (256, torch.bfloat16, (40, 24, 3)),
    (256, torch.bfloat16, (40, 16, 4)),
    (256, torch.float32, (40, 16, 2)),
])
def test_geometric_embedding_bwd_form_refuses_shapes_no_kernel_takes(c, dtype, bases):
    with pytest.raises(ValueError):
        emb_k.geometric_embedding_bwd_form(c, dtype, *bases)


@pytest.mark.parametrize("h,c,dtype,form", [
    (4, 64, torch.bfloat16, "tc"),      # the EQ cross layers in serving
    (4, 64, torch.float32, "cuda"),
    (4, 16, torch.float32, "cuda"),     # the tiny card-vs-CPU widths
    (4, 16, torch.bfloat16, "cuda"),
    (4, 32, torch.bfloat16, "cuda"),    # the wide-head family's EQ cross layers
    (4, 32, torch.float32, "cuda"),
])
def test_eq_attention_stats_form(h, c, dtype, form):
    """K6 takes the tc form in bf16 with H = 4 and head width 64, the
    CUDA-core form otherwise."""
    assert eq_k.eq_attention_stats_form(h, c, dtype) == form


@pytest.mark.parametrize("h,c,dtype", [
    (8, 64, torch.bfloat16),    # no kernel for H = 8
    (2, 16, torch.float32),     # nor H = 2
    (4, 128, torch.bfloat16),   # nor head width 128
    (4, 64, torch.float16),
])
def test_eq_attention_stats_form_refuses_shapes_no_kernel_takes(h, c, dtype):
    with pytest.raises(ValueError):
        eq_k.eq_attention_stats_form(h, c, dtype)


@pytest.mark.parametrize("n,c,dtype,parts", [
    (1024, 64, torch.bfloat16, 64), (1003, 64, torch.bfloat16, 63),
    (17, 64, torch.bfloat16, 2), (1, 64, torch.bfloat16, 1),
    (1024, 64, torch.float32, 128), (17, 16, torch.float32, 3),
    (17, 16, torch.bfloat16, 3), (1024, 32, torch.bfloat16, 128),
    (1003, 32, torch.float32, 126),
])
def test_eq_attention_stats_parts(n, c, dtype, parts):
    """One pooled partial slot per 16 query rows in the tc form, per 8 in
    the CUDA-core form; every slot is written by the kernel."""
    assert eq_k.eq_attention_stats_parts(4, n, c, dtype) == parts


@pytest.mark.parametrize("m", [1, 1024, 100_000])
def test_eq_attention_stats_plan_fits_a_block(m):
    """The tc form's shared memory (ring of key tiles, each consumer warp's
    q tile, the key-mask bits, mbarriers) fits one block of an H100."""
    plan = eq_k.eq_stats_smem_bytes(m)
    ring = eq_k.TC_STAGES * 4 * eq_k.TC_KEYS * 64 * 2
    q = eq_k.TC_CONSUMERS * 4 * eq_k.TC_UNIT_ROWS * 64 * 2
    assert ring + q + m // 8 < plan <= 232448 == eq_k.SMEM_LIMIT


def _eq_stats_args(**change):
    g = torch.Generator().manual_seed(0)
    args = dict(q=torch.randn((2, 4, 5, 16), generator=g),
                k=torch.randn((3, 4, 7, 16), generator=g),
                q_masks=torch.ones(5, dtype=torch.bool), k_masks=torch.ones(7, dtype=torch.bool),
                sup_q=None, sup_k=None)
    args.update(change)
    return args


@pytest.mark.parametrize("change,error", [
    (dict(k=torch.zeros((3, 4, 7, 8))), ValueError),                  # another head width
    (dict(k=torch.zeros((3, 2, 7, 16))), ValueError),                 # other heads
    (dict(q=torch.zeros((4, 5, 16))), ValueError),                    # not (A, H, N, c)
    (dict(k_masks=torch.ones(6, dtype=torch.bool)), ValueError),      # mask of another M
    (dict(q_masks=torch.ones((1, 5), dtype=torch.bool)), ValueError),
    (dict(sup_q=torch.ones((2, 4))), ValueError),                     # sup_q without sup_k
    (dict(sup_q=torch.ones((2, 3)), sup_k=torch.ones((3, 4))), ValueError),
    (dict(k=torch.zeros((3, 4, 7, 16), dtype=torch.bfloat16)), TypeError),
    (dict(positive="cube"), ValueError),
])
def test_eq_attention_stats_refuses_bad_inputs_on_the_cpu(change, error):
    """K6's wrapper checks its inputs on every device, the CPU included."""
    args = _eq_stats_args(**{k: v for k, v in change.items() if k != "positive"})
    with pytest.raises(error):
        eq_k.eq_attention_stats(**args, positive=change.get("positive", "sq"))


@pytest.mark.parametrize("h,c,dtype,form", [
    (4, 64, torch.bfloat16, "tc"),      # the EQ cross layers in serving
    (4, 64, torch.float32, "cuda"),
    (4, 16, torch.float32, "cuda"),     # the tiny card-vs-CPU widths
    (4, 16, torch.bfloat16, "cuda"),
    (4, 32, torch.bfloat16, "cuda"),    # the wide-head family's EQ cross layers
    (4, 32, torch.float32, "cuda"),
])
def test_eq_attention_apply_form(h, c, dtype, form):
    """K7 takes the tc form in bf16 with H = 4 and head width 64, the
    CUDA-core form otherwise."""
    assert eq_k.eq_attention_apply_form(h, c, dtype) == form


@pytest.mark.parametrize("h,c,dtype", [
    (8, 64, torch.bfloat16),    # no kernel for H = 8
    (2, 16, torch.float32),     # nor H = 2
    (4, 128, torch.bfloat16),   # nor head width 128
    (4, 64, torch.float16),
])
def test_eq_attention_apply_form_refuses_shapes_no_kernel_takes(h, c, dtype):
    with pytest.raises(ValueError):
        eq_k.eq_attention_apply_form(h, c, dtype)


@pytest.mark.parametrize("m", [1, 1024, 5000])
def test_eq_attention_apply_plan_fits_a_block(m):
    """The tc form's shared memory (ring of k and v tiles, the key-mask bits,
    mbarriers) fits one block of an H100."""
    plan = eq_k.eq_apply_smem_bytes(m)
    ring = eq_k.APPLY_STAGES * 2 * eq_k.APPLY_KEYS * 64 * 2
    assert ring + m // 8 < plan <= 232448 == eq_k.SMEM_LIMIT


def _eq_apply_args(**change):
    g = torch.Generator().manual_seed(0)
    args = dict(q=torch.randn((2, 4, 5, 16), generator=g),
                k=torch.randn((3, 4, 7, 16), generator=g),
                v=torch.randn((3, 4, 7, 16), generator=g),
                w_ae=torch.rand((2, 3), generator=g),
                rowmax=torch.zeros((2, 3, 4, 5)), rowsum=torch.ones((2, 3, 4, 5)),
                k_masks=torch.ones(7, dtype=torch.bool))
    args.update(change)
    return args


@pytest.mark.parametrize("change,error", [
    (dict(k=torch.zeros((3, 4, 7, 8))), ValueError),                  # another head width
    (dict(k=torch.zeros((3, 2, 7, 16))), ValueError),                 # other heads
    (dict(q=torch.zeros((4, 5, 16))), ValueError),                    # not (A, H, N, c)
    (dict(v=torch.zeros((3, 4, 6, 16))), ValueError),                 # v of another M
    (dict(v=torch.zeros((3, 4, 7, 16), dtype=torch.float64)), ValueError),
    (dict(w_ae=torch.ones((3, 2))), ValueError),                      # not (A, E)
    (dict(rowmax=torch.zeros((2, 3, 4, 6))), ValueError),             # stats of another N
    (dict(rowsum=torch.ones((2, 3, 5))), ValueError),
    (dict(k_masks=torch.ones(6, dtype=torch.bool)), ValueError),      # mask of another M
    (dict(k=torch.zeros((3, 4, 7, 16), dtype=torch.bfloat16)), TypeError),
])
def test_eq_attention_apply_refuses_bad_inputs_on_the_cpu(change, error):
    """K7's wrapper checks its inputs on every device, the CPU included."""
    with pytest.raises(error):
        eq_k.eq_attention_apply(**_eq_apply_args(**change))


@pytest.mark.parametrize("ac,infl_shape", [
    (12, (2, 5, 7, 15)),   # bf16 with H <= 64 (tensor-core form): AC not a multiple of 8
    (16, (2, 5, 6, 15)),   # fewer influence columns than neighbours
    (16, (2, 4, 7, 15)),   # another Nq
    (16, (2, 5, 7, 17)),   # K > 16
    (16, (2, 5, 7)),       # not (B, Nq, H', K)
])
def test_gather_wf_refuses_bad_shapes_on_the_cpu(ac, infl_shape):
    x = torch.zeros((2, 10, ac), dtype=torch.bfloat16)
    nbr = torch.zeros((2, 5, 7), dtype=torch.int32)
    with pytest.raises(ValueError):
        wc_k.gather_wf(x, nbr, torch.zeros(infl_shape, dtype=torch.bfloat16))


@pytest.mark.parametrize("h,dtype,form", [(65, torch.bfloat16, "first"),
                                          (7, torch.float32, "first")])
def test_gather_wf_first_design_takes_any_ac(h, dtype, form):
    """The first design's forms take AC = 12 (not a multiple of 8) and read
    the first H of H' > H influence columns, as the plain version does; the
    float32 case (a shape the rows form takes) asks for the first design by
    name."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(size=(2, 10, 12)).astype(np.float32)).to(dtype)
    nbr = torch.from_numpy(_neighbors(rng, 2, 5, 10, h))
    infl = torch.from_numpy(rng.rand(2, 5, h + 3, 15).astype(np.float32)).to(dtype)
    got = wc_k._gather_wf_forward(x, nbr, infl, form=form)
    assert got.shape == (2, 5, 15 * 12) and got.dtype == dtype
    assert torch.equal(got, wc_k.gather_wf_plain(x, nbr, infl[:, :, :h].contiguous()))
    assert torch.equal(got, wc_k.gather_wf(x, nbr, infl))


@pytest.mark.parametrize("dtype,h,rows", [
    pytest.param("float32", 6, "mixed", id="float32"),
    pytest.param("bfloat16", 6, "mixed", id="bfloat16"),
    *(pytest.param(dt, h, rows, id=f"{dt}-h{h}-{rows}")
      for dt in ("float32", "bfloat16")
      for h, rows in ((36, "mixed"), (40, "mixed"), (40, "sentinels"), (36, "full"))),
])
def test_neighbor_max_plain_matches_jax_exactly(dtype, h, rows):
    """K2 plain == max_pool_neighbors bit for bit; sentinel rows count as
    zero rows, all-sentinel rows give zeros.  H past 32 (more than one
    32-slot word of the kernel's mask), rows of only sentinels ("sentinels":
    every slot) and rows without one ("full")."""
    from se3et_tpu.nn.epn import max_pool_neighbors

    rng = np.random.RandomState(2)
    b, ns, nq = 2, 50, 30
    x = rng.normal(size=(b, ns, 6, 5)).astype(np.float32)
    nbr = _neighbors(rng, b, nq, ns, h)
    if rows == "sentinels":
        nbr[:] = ns
    if rows == "full":
        nbr = rng.randint(0, ns, size=(b, nq, h)).astype(np.int32)
    want = np.asarray(max_pool_neighbors(jnp.asarray(x, dtype), jnp.asarray(nbr)),
                      np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(b, ns, 30)
    got = wc_k.neighbor_max(xt, torch.from_numpy(nbr)).float().reshape(b, nq, 6, 5).numpy()
    np.testing.assert_array_equal(got, want)
    if rows == "sentinels":
        assert not got.any()


@pytest.mark.parametrize("ac,dtype,form", [
    (768, torch.bfloat16, "rows"), (3072, torch.bfloat16, "rows"),
    (768, torch.float32, "rows"), (1536, torch.float32, "rows"),
    (3072, torch.float32, "rows"),
    (30, torch.bfloat16, "first"), (6, torch.float32, "first"),
])
def test_neighbor_max_form(ac, dtype, form):
    """K2 takes the rows form where a row is whole 16-byte units, the first
    design otherwise."""
    assert wc_k.neighbor_max_form(ac, dtype) == form


@pytest.mark.parametrize("ac,dtype,su,slices", [
    (768, torch.bfloat16, 3, 1), (1536, torch.bfloat16, 3, 2), (3072, torch.bfloat16, 3, 4),
    (768, torch.float32, 3, 2), (1536, torch.float32, 3, 4), (3072, torch.float32, 3, 8),
    (8, torch.bfloat16, 1, 1), (800, torch.bfloat16, 2, 2), (4, torch.float32, 1, 1),
])
def test_neighbor_max_plan_covers_the_row(ac, dtype, su, slices):
    """The rows form's slices of 32 x SU units cover the row's units, the
    last slice holds some of them, and a lane's loads and maxima (4 (NB + 1)
    SU 32-bit registers) stay within 128 registers: the budget that lets
    two 8-warp blocks share an SM."""
    plan = wc_k.neighbor_max_plan(ac, dtype)
    units = ac * torch.empty((), dtype=dtype).element_size() // 16
    assert (plan.form, plan.su, plan.slices) == ("rows", su, slices)
    assert (plan.slices - 1) * 32 * plan.su < units <= plan.slices * 32 * plan.su
    assert 1 <= plan.su <= wc_k.ROWS_MAX_SU and plan.nb >= 1
    assert 4 * (plan.nb + 1) * plan.su <= 128 and plan.warps * 32 <= 1024


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


@pytest.mark.parametrize("m,n,form,lanes", [
    (65, 65, "rows", 2),        # serving: 64 points per patch + the dustbin
    (65, 33, "rows", 2),
    (129, 129, "rows", 4),      # KITTI's patch budget 128
    (144, 144, "rows", 4),      # the largest square the rows form holds
    (145, 145, "smem", 0),
    (168, 168, "smem", 0),      # the largest square the first design took
    (1, 11621, "smem", 0),      # the most lopsided shape it took
    (2, 2, "rows", 1),
])
def test_sinkhorn_plan_covers_the_accepted_shapes(m, n, form, lanes):
    """K4's plan takes every shape the first design's wrapper took (its
    2mn + 3(m + n) floats within one block's shared memory), the rows form
    where its register slices hold a row, and raises beyond."""
    plan = sk_k.sinkhorn_plan(m, n)
    assert (plan.form, plan.lanes) == (form, lanes) and sk_k.sinkhorn_form(m, n) == form
    assert plan.smem_bytes <= sk_k.SMEM_LIMIT
    if form == "rows":
        assert plan.lanes * plan.chunk >= max(m, n) and -(-max(m, n) // lanes) <= sk_k.MAX_CHUNK
        assert plan.warps * 32 >= max(m, n) * lanes


def test_sinkhorn_plan_accepts_what_the_first_design_took():
    """Over a grid of shapes, and at the edges of the smem limit, a shape
    has a plan exactly where the first design's (2mn + 3(m + n)) * 4 bytes
    fit 227 KB."""
    shapes = [(m, n) for m in range(1, 200, 7) for n in range(1, 200, 5)]
    shapes += [(168, 168), (169, 169), (1, 11621), (1, 11622), (2, 9294), (2, 9295),
               (0, 5), (5, 0)]
    for m, n in shapes:
        took = m >= 1 and n >= 1 and (2 * m * n + 3 * (m + n)) * 4 <= 227 * 1024
        if took:
            assert sk_k.sinkhorn_plan(m, n).form in ("rows", "smem")
        else:
            with pytest.raises(ValueError):
                sk_k.sinkhorn_plan(m, n)


@pytest.mark.parametrize("scores,mu,nu", [
    ((2, 5, 4), (2, 4), (2, 4)),     # log_mu of another M
    ((2, 5, 4), (2, 5), (2, 5)),     # log_nu of another N
    ((2, 5, 4), (3, 5), (2, 4)),     # another batch
    ((2, 5, 4), (2, 5, 1), (2, 4)),  # not (B, M)
    ((5, 4), (5,), (4,)),            # 2-D scores
])
def test_sinkhorn_refuses_bad_inputs_on_the_cpu(scores, mu, nu):
    """K4's wrapper checks its shapes on every device, the CPU included."""
    with pytest.raises(ValueError):
        sk_k.sinkhorn(torch.zeros(scores), torch.zeros(mu), torch.zeros(nu), 3)


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
