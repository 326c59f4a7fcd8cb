r"""Experiment configuration of the PyTorch port.

A torch-side copy of the JAX registry's ``se3ete.3dmatch`` entry
(``se3et_tpu/experiments/configs.py``), which cannot be imported where JAX
is absent (it pulls in flax and optax).  ``PyramidConfig`` is the shared
numpy pipeline's own class.  A test holds these values field-for-field
equal to the JAX ``make_cfg('se3ete.3dmatch')``.

:func:`serving_config` applies the two settings the port's serving slice
runs with (exact neighbour indexing, materialised attention).
"""

from __future__ import annotations

import dataclasses

from se3et_tpu.data.pipeline import PyramidConfig
from se3et_tpu_torch.nn.epn import EPNConfig
from se3et_tpu_torch.nn.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    seed: int
    dataset: str
    point_limit: int
    pipeline: PyramidConfig
    model: ModelConfig


SE3ET_E_BLOCKS = (
    "self_eq", "cross_a_soft", "self_eq", "cross_r_soft",
    "self", "cross", "self", "cross", "self", "cross",
)


def _threedmatch_pipeline(point_cap: int) -> PyramidConfig:
    # init_voxel_size 0.025, base_radius 2.5; values of the JAX registry
    return PyramidConfig(
        num_stages=4,
        voxel_size=0.025,
        search_radius=0.0625,
        neighbor_limits=(38, 36, 36, 38),
        stage_caps=(point_cap, point_cap // 2, point_cap // 8, 1024),
        coarse_point_cap=1024,
        input_dim=1,
        window_segments_by_set=(
            ("neighbors_0", 32), ("subsampling_0", 48),
            ("neighbors_1", 96), ("subsampling_1", 160),
            ("neighbors_2", 96), ("subsampling_2", 128),
            ("neighbors_3", 24),
        ),
        window_sseg_by_set=(
            ("neighbors_0", 8), ("subsampling_0", 8),
            ("neighbors_1", 4), ("subsampling_1", 4),
            ("neighbors_2", 4), ("subsampling_2", 4),
        ),
        patch_k=64,
        neighbor_h_caps_by_set=(
            ("neighbors_0", 24), ("subsampling_0", 24),
            ("neighbors_1", 32), ("subsampling_1", 32),
        ),
    )


def _se3ete_3dmatch() -> ExperimentConfig:
    point_limit = 20000
    model = ModelConfig(
        compute_dtype="bfloat16",
        backbone="e2pn",
        num_stages=4,
        init_dim=64,
        output_dim=256,
        kernel_size=15,
        init_radius=0.0625,
        init_sigma=0.05,
        group_norm=32,
        epn=EPNConfig(kanchor=6, quotient_factor=4, num_kernel_points=15,
                      steerability="exact"),
        gt_input_dim=64 * 16,
        gt_hidden_dim=256,
        gt_output_dim=256,
        num_heads=4,
        blocks=SE3ET_E_BLOCKS,
        sigma_d=0.2,
        sigma_a=15.0,
        angle_k=3,
        n_level_equiv=2,
        attn_r_positive="sq",
        attn_r_positive_rot_supervise="sigmoid",
        ground_truth_matching_radius=0.05,
        num_points_in_patch=64,
        num_sinkhorn_iterations=100,
        num_targets=128,
        overlap_threshold=0.1,
        num_correspondences=256,
        fine_topk=3,
        acceptance_radius=0.1,
        confidence_threshold=0.05,
        correspondence_threshold=3,
        correspondence_limit=2048,
        num_refinement_steps=5,
    )
    return ExperimentConfig(
        name="se3ete.3dmatch", seed=7351, dataset="threedmatch",
        point_limit=point_limit, pipeline=_threedmatch_pipeline(min(point_limit, 24576)),
        model=model,
    )


EXPERIMENTS = {"se3ete.3dmatch": _se3ete_3dmatch}


def make_cfg(name: str) -> ExperimentConfig:
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; available: {sorted(EXPERIMENTS)}")
    return EXPERIMENTS[name]()


def serving_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """The port's serving slice of ``cfg``: neighbours indexed directly
    (``window_segments=0``: the Morton window maps exist only for the TPU
    kernels) and the materialised-score attention routes
    (``serve_fused_attention=False``: the flash attention kernels are not
    ported yet)."""
    return dataclasses.replace(
        cfg,
        pipeline=dataclasses.replace(cfg.pipeline, window_segments=0),
        model=dataclasses.replace(cfg.model, serve_fused_attention=False),
    )


def tiny_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """A few-point, narrow float32 cut of ``cfg`` for CPU tests and the
    card-vs-CPU check: the values of the JAX package's
    ``__graft_entry__._flagship_configs(tiny=True)`` (exact neighbours,
    materialised attention) with the host point-to-node partition on."""
    pipeline = PyramidConfig(
        num_stages=4, voxel_size=0.14, search_radius=0.35,
        neighbor_limits=(8, 8, 8, 8), stage_caps=(128, 64, 32, 24),
        coarse_point_cap=24, window_segments=0, patch_k=8,
    )
    model = dataclasses.replace(
        cfg.model, compute_dtype="float32", init_dim=16, output_dim=64,
        gt_input_dim=256, gt_hidden_dim=64, gt_output_dim=64, init_radius=0.35,
        init_sigma=0.28, group_norm=8, num_points_in_patch=8,
        num_sinkhorn_iterations=5, num_targets=8, num_correspondences=12,
        gt_candidates=8, correspondence_limit=64, train_fused_conv=False,
        train_fused_embedding=False, train_fused_attention=False,
        serve_fused_attention=False,
    )
    return dataclasses.replace(cfg, pipeline=pipeline, model=model)


def synthetic_extent(dataset: str) -> float:
    """Scene extent of the synthetic pair generator per dataset family
    (3DMatch rooms ~3-4 m: 2.0; ModelNet objects: 0.8; LiDAR: 20)."""
    return {"threedmatch": 2.0, "kitti_test": 2.0, "modelnet": 0.8}.get(dataset, 20.0)
