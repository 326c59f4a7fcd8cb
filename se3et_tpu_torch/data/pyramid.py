r"""Host side of a serving pair for the PyTorch port.

A pair is the padded two-cloud pyramid dict of the numpy pipeline
(:func:`se3et_tpu_torch.data.pipeline.build_pair_pyramid`: voxel pyramid,
radius neighbours, host point-to-node partition) plus the port's float32
influence weights (:func:`se3et_tpu_torch.data.influence.precompute_influence`).
``SE3ETModel.forward`` needs both.
"""

from __future__ import annotations

from se3et_tpu_torch.data.datasets import SyntheticPairDataset
from se3et_tpu_torch.data.pipeline import build_pair_pyramid
from se3et_tpu_torch.data.influence import precompute_influence


def build_pair(ref_points, src_points, transform, pipeline, model_cfg) -> dict:
    """numpy pyramid dict of one (ref, src) pair, with influence weights."""
    data = build_pair_pyramid(ref_points, src_points, transform, pipeline)
    return precompute_influence(data, model_cfg)


def synthetic_pair(index, pipeline, model_cfg, num_points, extent, seed=0) -> dict:
    """Pair ``index`` of the synthetic scene generator, built by
    :func:`build_pair`."""
    item = SyntheticPairDataset(num_pairs=index + 1, num_points=num_points,
                                extent=extent, seed=seed)[index]
    return build_pair(item["ref_points"], item["src_points"], item["transform"],
                      pipeline, model_cfg)
