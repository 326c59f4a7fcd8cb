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
    (1024, 1024, 38, 1536),    # stage-3 conv (factored weights)
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_wf_kernel(cuda, nq, ns, h, ac, dtype):
    g = torch.Generator().manual_seed(0)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    _assert_ok(selfcheck.check_gather_wf(nbr, ns, ac, dtype=dtype, reps=1))


@pytest.mark.parametrize("nq,ns,h,ac", [(10000, 20000, 24, 768), (1024, 2500, 38, 3072)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_neighbor_max_kernel(cuda, nq, ns, h, ac, dtype):
    g = torch.Generator().manual_seed(1)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    _assert_ok(selfcheck.check_neighbor_max(nbr, ns, ac, dtype=dtype, reps=1))


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


def _cloud(cuda, n, seed, pad=40):
    """(2, n, 3) points in a 4 m box with ``pad`` padded (zero, masked)
    points at the end of cloud 1, and their (2, n) masks."""
    g = torch.Generator().manual_seed(seed)
    points = (torch.rand((2, n, 3), generator=g) * 4 - 2).to(cuda)
    masks = torch.ones((2, n), dtype=torch.bool, device=cuda)
    masks[1, -pad:] = False
    points[1, -pad:] = 0.0
    return points, masks


@pytest.mark.parametrize("n,ah,c,cc,with_sh,dtype", [
    (1024, 24, 64, 256, True, torch.bfloat16),    # self_eq layers
    (1024, 4, 64, 256, False, torch.bfloat16),    # plain self layers
    (1003, 24, 64, 256, True, torch.bfloat16),    # ragged N
    (128, 24, 16, 64, True, torch.float32),       # tiny card-vs-CPU widths
    (128, 4, 16, 64, False, torch.float32),
])
def test_rpe_attention_kernel(cuda, n, ah, c, cc, with_sh, dtype):
    points, masks = _cloud(cuda, n, 4)
    _assert_ok(selfcheck.check_rpe_attention(points, masks, ah, c=c, cc=cc,
                                             with_sh=with_sh, dtype=dtype, reps=1))


@pytest.mark.parametrize("n,m,c,dtype", [
    (1024, 1024, 64, torch.bfloat16),   # EQ cross layers
    (1003, 997, 64, torch.bfloat16),    # ragged N and M
    (128, 128, 16, torch.float32),      # tiny card-vs-CPU widths
])
@pytest.mark.parametrize("with_sup", [False, True])
def test_eq_attention_stats_kernel(cuda, n, m, c, dtype, with_sup):
    qm = torch.arange(n, device=cuda) < n - 24
    km = torch.arange(m, device=cuda) < m - 40
    _assert_ok(selfcheck.check_eq_stats(qm, km, c=c, with_sup=with_sup, dtype=dtype,
                                        reps=1))


@pytest.mark.parametrize("n,m,c,dtype", [
    (1024, 1024, 64, torch.bfloat16),
    (1003, 997, 64, torch.bfloat16),
    (128, 128, 16, torch.float32),
])
def test_eq_attention_apply_kernel(cuda, n, m, c, dtype):
    qm = torch.arange(n, device=cuda) < n - 24
    km = torch.arange(m, device=cuda) < m - 40
    _assert_ok(selfcheck.check_eq_apply(qm, km, c=c, dtype=dtype, reps=1))


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


@pytest.mark.parametrize("nq,ns,h,ac", [(10000, 20000, 24, 768), (1024, 2500, 38, 3072),
                                        (97, 250, 5, 40)])
def test_neighbor_max_bwd_kernel(cuda, nq, ns, h, ac):
    g = torch.Generator().manual_seed(8)
    nbr = torch.cat([selfcheck.local_neighbors(nq, ns, h, g, cuda) for _ in range(2)])
    _assert_ok(selfcheck.check_neighbor_max_bwd(nbr, ns, ac, reps=1))


@pytest.mark.parametrize("n,c,grad_dtype", [(1024, 256, torch.bfloat16),
                                            (1003, 256, torch.bfloat16),
                                            (128, 64, torch.bfloat16),
                                            (128, 64, torch.float32)])
def test_geometric_embedding_bwd_kernel(cuda, n, c, grad_dtype):
    points, masks = _cloud(cuda, n, 9)
    _assert_ok(selfcheck.check_embedding_bwd(points, masks, c=c, grad_dtype=grad_dtype,
                                             reps=1))


@pytest.mark.parametrize("n,ah,c,cc,with_sh,dtype", [
    (1024, 24, 64, 256, True, torch.bfloat16),    # self_eq layers
    (1024, 4, 64, 256, False, torch.bfloat16),    # plain self layers
    (1003, 24, 64, 256, True, torch.bfloat16),    # ragged N
    (128, 24, 16, 64, True, torch.bfloat16),      # tiny card-vs-CPU widths (training: bf16)
    (128, 4, 16, 64, False, torch.float32),
])
def test_rpe_attention_bwd_kernel(cuda, n, ah, c, cc, with_sh, dtype):
    points, masks = _cloud(cuda, n, 10)
    _assert_ok(selfcheck.check_rpe_attention_bwd(points, masks, ah, c=c, cc=cc,
                                                 with_sh=with_sh, dtype=dtype, reps=1))


@pytest.mark.parametrize("ah,with_sh", [(24, True), (4, False)])
def test_rpe_attention_row_stats_leave_the_output_unchanged(cuda, ah, with_sh):
    """K5 with and without its row log-sum-exp output gives the same out
    (bit for bit), and the log-sum-exp agrees with the plain version's."""
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    points, masks = _cloud(cuda, 1024, 4)
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


@pytest.mark.parametrize("n,ah,c,cc,with_sh,dtype", [
    (1024, 24, 64, 256, True, torch.bfloat16),    # self_eq layers
    (1024, 4, 64, 256, False, torch.bfloat16),    # plain self layers
    (1024, 24, 64, 256, False, torch.bfloat16),
    (1024, 4, 64, 256, True, torch.bfloat16),
    (1003, 24, 64, 256, True, torch.bfloat16),    # ragged N
    (128, 24, 16, 64, True, torch.float32),       # tiny card-vs-CPU widths
    (128, 4, 16, 64, False, torch.float32),
    (128, 24, 64, 64, True, torch.float32),       # float32 at the serving head width
])
def test_rpe_attention_femb_kernel(cuda, n, ah, c, cc, with_sh, dtype):
    points, masks = _cloud(cuda, n, 18)
    _assert_ok(selfcheck.check_rpe_attention_femb(points, masks, ah, c=c, cc=cc,
                                                  with_sh=with_sh, dtype=dtype, reps=1))
