"""The port's CUDA kernels (K1-K4) against their plain versions on the card,
at the serving shapes of se3ete.3dmatch.  Skipped where no CUDA device is
present; run on the card with ``python -m pytest -m gpu tests/test_torch_kernels_cuda.py``.
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
