r"""Experiment registry of the PyTorch port.

A torch-side copy of the JAX registry's 3DMatch SE3ET entries
(``se3et_tpu/experiments/configs.py``), which cannot be imported where JAX
is absent (it pulls in flax and optax): ``se3ete.3dmatch``,
``se3ete.3dmatch.evalrot``, ``se3eti.3dmatch`` and
``se3eti.3dmatch.evalrot`` at full width (head width 64), and the
wide-head family at head width 32 (``hidden`` 128 over 4 heads,
``init_dim`` 32, ``group_norm`` 16, point limit 30000):
``se3ete2.3dmatch``, ``se3ete2.3dmatch.evalrot``, ``se3eti2.3dmatch``,
``se3eti2.3dmatch.evalrot`` and ``se3eti2.3dmatch.evalkitti`` (KITTI data
on the 3DMatch model; its test path raises until the KITTI loader is
ported).  ``PyramidConfig`` is the port's copy of the numpy pipeline's
class.  A test holds every entry field-for-field equal to the JAX
``make_cfg`` of the same name.

:func:`serving_config` applies the setting the port's serving slice runs
with (exact neighbour indexing); attention takes the JAX default, the
flash kernels.  The training step runs on the same cut, its routes
(``train_fused_*``) at the JAX defaults.
"""

from __future__ import annotations

import dataclasses
import os.path as osp
from typing import Optional

from se3et_tpu_torch.data.pipeline import PyramidConfig
from se3et_tpu_torch.engine.trainer import OptimConfig
from se3et_tpu_torch.nn.epn import EPNConfig
from se3et_tpu_torch.nn.loss import EvalConfig, LossConfig
from se3et_tpu_torch.nn.model import ModelConfig

REPO_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Field-for-field the JAX ``DataConfig``."""

    dataset: str = "threedmatch"  # 'threedmatch' | 'kitti' | 'modelnet' | 'synthetic'
    dataset_root: str = osp.join(REPO_ROOT, "data", "3DMatch")
    train_subset: str = "train"
    val_subset: str = "val"
    benchmarks: tuple[str, ...] = ("3DMatch", "3DLoMatch")
    point_limit: Optional[int] = 20000
    test_point_limit: Optional[int] = None
    batch_size: int = 1
    use_augmentation: bool = True
    augmentation_noise: float = 0.005
    augmentation_rotation: float = 1.0
    rotated: bool = False
    z_rotated: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    seed: int
    data: DataConfig
    pipeline: PyramidConfig
    model: ModelConfig
    loss: LossConfig
    eval: EvalConfig
    optim: OptimConfig

    @property
    def output_dir(self) -> str:
        """``output/torch/<name>``: the JAX package writes its snapshots and
        dumps under ``output/<name>``, and each package keeps its own."""
        return osp.join(REPO_ROOT, "output", "torch", self.name)


SE3ET_E_BLOCKS = (
    "self_eq", "cross_a_soft", "self_eq", "cross_r_soft",
    "self", "cross", "self", "cross", "self", "cross",
)
SE3ET_I_BLOCKS = ("self_eq", "cross", "self_eq", "cross", "self_eq", "cross")


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


def _se3et_3dmatch(name: str, blocks, point_limit: int, init_dim: int = 64,
                   output_dim: int = 256, hidden: int = 256, group_norm: int = 32,
                   n_level_equiv: int = 0, attn_r_positive: str = "sq",
                   attn_r_positive_rot_supervise: str = "sigmoid",
                   rotated: bool = False) -> ExperimentConfig:
    """The JAX registry's ``_se3et_3dmatch`` (exact steerability) with its
    width keywords: the defaults are SE3ET-E's and SE3ET-I's (head width
    64); the wide-head family passes ``init_dim`` 32, ``output_dim`` and
    ``hidden`` 128 and ``group_norm`` 16 (head width 32)."""
    model = ModelConfig(
        compute_dtype="bfloat16",
        backbone="e2pn",
        num_stages=4,
        init_dim=init_dim,
        output_dim=output_dim,
        kernel_size=15,
        init_radius=0.0625,
        init_sigma=0.05,
        group_norm=group_norm,
        epn=EPNConfig(kanchor=6, quotient_factor=4, num_kernel_points=15,
                      steerability="exact"),
        gt_input_dim=init_dim * 16,
        gt_hidden_dim=hidden,
        gt_output_dim=hidden,
        num_heads=4,
        blocks=tuple(blocks),
        sigma_d=0.2,
        sigma_a=15.0,
        angle_k=3,
        n_level_equiv=n_level_equiv,
        attn_r_positive=attn_r_positive,
        attn_r_positive_rot_supervise=attn_r_positive_rot_supervise,
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
        name=name, seed=7351,
        data=DataConfig(dataset="threedmatch", point_limit=point_limit, rotated=rotated),
        pipeline=_threedmatch_pipeline(min(point_limit, 24576)),
        model=model,
        loss=LossConfig(positive_margin=0.1, negative_margin=1.4, positive_optimal=0.1,
                        negative_optimal=1.4, log_scale=24.0, positive_overlap=0.1,
                        fine_positive_radius=0.05, kanchor=6),
        eval=EvalConfig(acceptance_overlap=0.0, acceptance_radius=0.1, rmse_threshold=0.2,
                        rre_threshold=15.0, rte_threshold=0.3),
        optim=OptimConfig(lr=1e-4, lr_decay=0.95, lr_decay_steps=1, weight_decay=1e-6,
                          max_epoch=40),
    )


# SE3ET-I: no equivariant levels (n_level_equiv 0), so its self_eq layers
# carry no SH term and a plain cross layer follows each; the rotation
# supervision's positive() mode is set but unread while supervise_rotation
# is off, in both packages
_SE3ETI = dict(attn_r_positive="softplus", attn_r_positive_rot_supervise="minus")
# the wide-head family (se3ete2 / se3eti2): head width 32
_WIDE = dict(init_dim=32, output_dim=128, hidden=128, group_norm=16)

EXPERIMENTS = {
    "se3ete.3dmatch": lambda: _se3et_3dmatch(
        "se3ete.3dmatch", SE3ET_E_BLOCKS, 20000, n_level_equiv=2),
    "se3ete.3dmatch.evalrot": lambda: _se3et_3dmatch(
        "se3ete.3dmatch.evalrot", SE3ET_E_BLOCKS, 20000, n_level_equiv=2, rotated=True),
    "se3eti.3dmatch": lambda: _se3et_3dmatch(
        "se3eti.3dmatch", SE3ET_I_BLOCKS, 10000, **_SE3ETI),
    "se3eti.3dmatch.evalrot": lambda: _se3et_3dmatch(
        "se3eti.3dmatch.evalrot", SE3ET_I_BLOCKS, 10000, rotated=True, **_SE3ETI),
    "se3ete2.3dmatch": lambda: _se3et_3dmatch(
        "se3ete2.3dmatch", SE3ET_E_BLOCKS, 30000, n_level_equiv=2, **_WIDE),
    "se3ete2.3dmatch.evalrot": lambda: _se3et_3dmatch(
        "se3ete2.3dmatch.evalrot", SE3ET_E_BLOCKS, 30000, n_level_equiv=2, rotated=True,
        **_WIDE),
    "se3eti2.3dmatch": lambda: _se3et_3dmatch(
        "se3eti2.3dmatch", SE3ET_I_BLOCKS, 30000, **_WIDE, **_SE3ETI),
    "se3eti2.3dmatch.evalrot": lambda: _se3et_3dmatch(
        "se3eti2.3dmatch.evalrot", SE3ET_I_BLOCKS, 30000, rotated=True, **_WIDE, **_SE3ETI),
    # the 3DMatch model on KITTI's test sequences (the JAX entry replaces
    # the data only); the KITTI loader is not ported, so its test path raises
    "se3eti2.3dmatch.evalkitti": lambda: dataclasses.replace(
        make_cfg("se3eti2.3dmatch"), name="se3eti2.3dmatch.evalkitti",
        data=DataConfig(dataset="kitti", dataset_root=osp.join(REPO_ROOT, "data", "Kitti"),
                        benchmarks=("test",), point_limit=30000)),
}


def make_cfg(name: str) -> ExperimentConfig:
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; available: {sorted(EXPERIMENTS)}")
    return EXPERIMENTS[name]()


def serving_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """The port's serving slice of ``cfg``: neighbours indexed directly
    (``window_segments=0``: the Morton window maps exist only for the TPU
    kernels).  ``serve_fused_attention`` keeps its value (True, the JAX
    default: flash RPE self-attention and EQ cross-attention kernels).  The
    training step runs on this cut too: its routes keep the JAX defaults
    (``train_fused_*`` on: the backward kernels K8-K11, float32 features,
    materialised EQ cross layers)."""
    return dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, window_segments=0))


# the tiny cut's widths by the entry's transformer width: SE3ET-E / SE3ET-I
# (hidden 256) at __graft_entry__'s tiny flagship widths (head width 16);
# the wide-head family (hidden 128) keeps its head width 32 and group norm
# of 16 groups, so its init_dim 32 (the stage-0 bottleneck's 16 channels)
_TINY_WIDTHS = {
    256: dict(init_dim=16, gt_input_dim=256, gt_hidden_dim=64, gt_output_dim=64,
              group_norm=8),
    128: dict(init_dim=32, gt_input_dim=512, gt_hidden_dim=128, gt_output_dim=128,
              group_norm=16),
}


def tiny_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """A few-point, narrow float32 cut of ``cfg`` for CPU tests and the
    card-vs-CPU check: the values of the JAX package's
    ``__graft_entry__._flagship_configs(tiny=True)`` (exact neighbours,
    materialised attention) with the host point-to-node partition on; for
    the wide-head family the transformer keeps its width 128 (head width 32)
    and the backbone its group norm of 16 groups (:data:`_TINY_WIDTHS`)."""
    pipeline = PyramidConfig(
        num_stages=4, voxel_size=0.14, search_radius=0.35,
        neighbor_limits=(8, 8, 8, 8), stage_caps=(128, 64, 32, 24),
        coarse_point_cap=24, window_segments=0, patch_k=8,
    )
    model = dataclasses.replace(
        cfg.model, compute_dtype="float32", output_dim=64,
        **_TINY_WIDTHS[cfg.model.gt_hidden_dim], init_radius=0.35,
        init_sigma=0.28, num_points_in_patch=8,
        num_sinkhorn_iterations=5, num_targets=8, num_correspondences=12,
        gt_candidates=8, correspondence_limit=64, train_fused_conv=False,
        train_fused_embedding=False, train_fused_attention=False,
        serve_fused_attention=False,
    )
    return dataclasses.replace(cfg, pipeline=pipeline, model=model)


def tiny_flash_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """:func:`tiny_config` with a 128-point coarse stage and the flash
    attention route on (the flash self layers need ``N % 128 == 0``);
    built for about 600 input points."""
    tiny = tiny_config(cfg)
    return dataclasses.replace(
        tiny,
        pipeline=dataclasses.replace(tiny.pipeline, stage_caps=(256, 192, 160, 128),
                                     coarse_point_cap=128),
        model=dataclasses.replace(tiny.model, serve_fused_attention=True),
    )


def synthetic_extent(dataset: str) -> float:
    """Scene extent of the synthetic pair generator per dataset family
    (3DMatch rooms ~3-4 m: 2.0; ModelNet objects: 0.8; LiDAR: 20)."""
    return {"threedmatch": 2.0, "kitti_test": 2.0, "modelnet": 0.8}.get(dataset, 20.0)
