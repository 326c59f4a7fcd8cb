"""The port's CUDA kernels (K1-K7) against their plain versions on the card,
at the serving shapes of se3ete.3dmatch, at ragged shapes (N not a multiple
of any block) and at the tiny float32 widths of the card-vs-CPU check.
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


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_geometric_embedding_kernel(cuda, out_dtype):
    g = torch.Generator().manual_seed(2)
    points = (torch.rand((2, 1024, 3), generator=g) * 4 - 2).to(cuda)
    masks = torch.ones((2, 1024), dtype=torch.bool, device=cuda)
    masks[1, -40:] = False
    points[1, -40:] = 0.0
    _assert_ok(selfcheck.check_embedding(points, masks, out_dtype=out_dtype, reps=1))


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
