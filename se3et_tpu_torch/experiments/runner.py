r"""Experiment entry points of the PyTorch port: trainval / test / eval /
eval_dgr / demo (port of :mod:`se3et_tpu.experiments.runner`).

    python -m se3et_tpu_torch.experiments.runner se3eti2.3dmatch trainval --max_epoch 1
    python -m se3et_tpu_torch.experiments.runner se3eti.3dmatch test --max_pairs 4
    python -m se3et_tpu_torch.experiments.runner se3eti.3dmatch eval --method lgr
    python -m se3et_tpu_torch.experiments.runner se3ete.3dmatch.evalrot demo

``trainval`` trains the experiment with the port's
:class:`~se3et_tpu_torch.engine.trainer.Trainer` (an epoch of training
pairs, validation, the snapshots ``epoch-<n>`` and ``latest`` under
``output/torch/<name>/snapshots``; ``--resume`` starts from ``latest``).
``test`` serves the benchmark's pairs through the captured eval forward on
the card (:class:`~se3et_tpu_torch.engine.tester.Tester`) and dumps their
features under ``output/torch/<name>/features``; ``eval`` and ``eval_dgr``
evaluate those dumps offline; ``demo`` registers one pair and the same pair
with its source rotated, and writes PLYs.  ``--device cpu`` runs
``trainval``, ``test`` and ``demo`` on the CPU; without it they need a CUDA
device.

The configuration takes the port's serving cut (:func:`serving_config`:
neighbours indexed directly), which training runs on too.  Where the
dataset's metadata is absent the pairs come from the synthetic generator,
as in the JAX runner.  ``test`` and ``demo`` take the weights of a snapshot
of the port (``--snapshot``, ``--test_epoch``, ``--test_iter``, else
``latest`` where it exists), or draw them from the experiment's seed; a
snapshot of the JAX package (orbax) raises until its importer is ported
(ROADMAP §A5).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import os
import os.path as osp
import sys

import numpy as np
import torch

from se3et_tpu_torch.core import se3
from se3et_tpu_torch.data import datasets as ds_lib
from se3et_tpu_torch.data import pipeline as pipe_lib
from se3et_tpu_torch.data.pyramid import build_pair
from se3et_tpu_torch.engine.steps import make_forward
from se3et_tpu_torch.engine.tester import Tester, evaluate_benchmark
from se3et_tpu_torch.engine.trainer import SNAPSHOT_FILE, Trainer
from se3et_tpu_torch.experiments.configs import (
    ExperimentConfig, make_cfg, serving_config, synthetic_extent,
)
from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
from se3et_tpu_torch.utils import pointcloud_io as pc_io
from se3et_tpu_torch.utils.summary import get_logger


def build_dataset(cfg: ExperimentConfig, subset: str, training: bool):
    """The 3DMatch loader where ``<dataset_root>/metadata/<subset>.pkl``
    exists, else the synthetic pair generator (32 training pairs, 8 test
    pairs of at most 6000 points), as the JAX runner falls back.  The KITTI
    and ModelNet loaders are not ported: a KITTI dataset raises always (no
    synthetic pairs stand in for its sweeps: ``se3eti2.3dmatch.evalkitti``
    waits for the loader), a ModelNet one where its metadata exists."""
    d = cfg.data
    if d.dataset in ("kitti", "kitti_test"):
        raise NotImplementedError(
            f"{cfg.name}: the KITTI loader ({d.dataset}) is not ported (ROADMAP §A5)")
    if d.dataset == "threedmatch":
        if osp.isfile(osp.join(d.dataset_root, "metadata", f"{subset}.pkl")):
            return ds_lib.ThreeDMatchPairDataset(
                d.dataset_root, subset,
                point_limit=d.point_limit if training else d.test_point_limit,
                use_augmentation=training and d.use_augmentation,
                augmentation_noise=d.augmentation_noise,
                augmentation_rotation=d.augmentation_rotation,
                rotated=d.rotated, z_rotated=d.z_rotated,
            )
    elif d.dataset == "modelnet":
        if osp.isfile(osp.join(d.dataset_root, f"{subset}.pkl")):
            raise NotImplementedError(f"the {d.dataset} loader is not ported (ROADMAP §A5)")
    get_logger().warning(f"dataset {d.dataset}/{subset} not found under {d.dataset_root}; "
                         "falling back to the synthetic pair generator")
    return ds_lib.SyntheticPairDataset(
        num_pairs=32 if training else 8,
        num_points=min(d.point_limit or 6000, 6000),
        extent=synthetic_extent(d.dataset),
        seed=0 if training else 1,
    )


def with_calibrated_limits(cfg: ExperimentConfig, max_pairs: int = 8):
    """Replace the pipeline's neighbour widths by ones calibrated on up to
    ``max_pairs`` training pairs (:func:`pipeline.calibrate_neighbor_limits`),
    cached in ``<output_dir>/neighbor_limits.json`` so that calibration runs
    once per experiment.  The limits are logged either way."""
    cache = osp.join(cfg.output_dir, "neighbor_limits.json")
    if osp.isfile(cache):
        with open(cache) as f:
            limits = tuple(json.load(f))
        source = f"cached in {cache}"
    else:
        train_ds = build_dataset(cfg, cfg.data.train_subset, training=True)
        sample = ((train_ds[i]["ref_points"], train_ds[i]["src_points"])
                  for i in range(min(len(train_ds), max_pairs)))
        limits = pipe_lib.calibrate_neighbor_limits(sample, cfg.pipeline)
        os.makedirs(cfg.output_dir, exist_ok=True)
        with open(cache, "w") as f:
            json.dump(list(limits), f)
        source = "calibrated"
    get_logger().info(f"neighbor limits {limits} ({source})")
    return dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, neighbor_limits=limits))


def pyramid_loader(dataset, cfg: ExperimentConfig, with_meta=False, workers=4, limit=None):
    """Generator of the dataset's padded pyramids with the host's influence
    weights, built in a pool of ``workers`` threads and prefetched; with
    ``limit``, of its first ``limit`` pairs only (nothing is built past
    them)."""

    def build(i):
        item = dataset[i]
        data = build_pair(item["ref_points"], item["src_points"], item["transform"],
                          cfg.pipeline, cfg.model)
        meta = {k: v for k, v in item.items()
                if k not in ("ref_points", "src_points", "transform")}
        return (data, meta) if with_meta else data

    indices = list(range(len(dataset)))[:limit]
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        futures = [ex.submit(build, i) for i in indices[: 2 * workers]]
        next_submit = len(futures)
        for i in range(len(indices)):
            yield futures[i].result()
            futures[i] = None
            if next_submit < len(indices):
                futures.append(ex.submit(build, indices[next_submit]))
                next_submit += 1


def run_trainval(cfg: ExperimentConfig, argv=None):
    """Train the experiment (the JAX runner's ``run_trainval``, argument for
    argument, plus ``--device``) on its serving cut with calibrated limits
    unless ``--no_calibrate``; ``--max_steps_per_epoch`` cuts the training
    and the validation loaders alike.  Returns the trainer."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--max_steps_per_epoch", type=int, default=None)
    parser.add_argument("--no_calibrate", action="store_true",
                        help="skip neighbor-limit calibration")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = serving_config(cfg)
    if not args.no_calibrate:
        cfg = with_calibrated_limits(cfg)
    optim = cfg.optim
    if args.max_epoch is not None:
        optim = dataclasses.replace(optim, max_epoch=args.max_epoch)

    train_ds = build_dataset(cfg, cfg.data.train_subset, training=True)
    val_ds = build_dataset(cfg, cfg.data.val_subset, training=False)
    trainer = Trainer(cfg.model, cfg.loss, cfg.eval, optim, cfg.output_dir, seed=cfg.seed,
                      batch_size=cfg.data.batch_size, device=args.device)
    steps = len(train_ds)
    if args.max_steps_per_epoch:
        steps = min(steps, args.max_steps_per_epoch)
    # the port's weights do not depend on an example pair
    trainer.initialize(None, steps_per_epoch=steps)

    limit = args.max_steps_per_epoch or None
    trainer.run(lambda: pyramid_loader(train_ds, cfg, limit=limit),
                lambda: pyramid_loader(val_ds, cfg, limit=limit), resume=args.resume)
    return trainer


def _load_params(cfg: ExperimentConfig, snapshot: str | None) -> dict:
    """The model's weights (its ``state_dict``): the port's snapshot
    ``<snapshot>/snapshot.pt`` (or the file itself), else, without a
    snapshot, drawn from ``cfg.seed``.  A directory without the port's file
    (an orbax snapshot of the JAX package) raises: its importer is not
    ported (ROADMAP §A5)."""
    if not snapshot:
        return SE3ETModel(cfg.model, seed=cfg.seed, device="cpu").state_dict()
    path = osp.join(snapshot, SNAPSHOT_FILE) if osp.isdir(snapshot) else snapshot
    if osp.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)["model"]
    if osp.isdir(snapshot):
        raise NotImplementedError(
            f"{snapshot!r} is not a snapshot of the port (no {SNAPSHOT_FILE}): the importer "
            "of the JAX package's orbax snapshots is not ported (ROADMAP §A5)")
    raise FileNotFoundError(f"no snapshot at {snapshot!r}")


def apply_cfg_overrides(cfg: ExperimentConfig, overrides: dict) -> ExperimentConfig:
    """Apply dotted-key overrides (e.g. ``{"model.fine_topk": 2}``) to the
    frozen config tree."""
    for key, value in overrides.items():
        parts = key.split(".")
        node_path = []
        node = cfg
        for p in parts[:-1]:
            node_path.append((node, p))
            node = getattr(node, p)
        node = dataclasses.replace(node, **{parts[-1]: value})
        for parent, name in reversed(node_path):
            node = dataclasses.replace(parent, **{name: node})
        cfg = node
    return cfg


def _resolve_snapshot(cfg: ExperimentConfig, args) -> str | None:
    """``--snapshot`` | ``--test_epoch`` | ``--test_iter``, else
    ``<output_dir>/snapshots/latest`` where it exists."""
    if getattr(args, "snapshot", None):
        return args.snapshot
    snap_dir = osp.join(cfg.output_dir, "snapshots")
    if getattr(args, "test_epoch", None) is not None:
        return osp.join(snap_dir, f"epoch-{args.test_epoch}")
    if getattr(args, "test_iter", None) is not None:
        return osp.join(snap_dir, f"iter-{args.test_iter}")
    latest = osp.join(snap_dir, "latest")
    return latest if osp.isdir(latest) else None


def prepare_test(cfg: ExperimentConfig, argv=None):
    """``run_test``'s set-up: (tester, loader, benchmark).  The tester is
    built with the snapshot's weights (:func:`_resolve_snapshot`), else the
    seed's, on the configuration's serving cut with calibrated limits;
    ``loader`` yields the benchmark's (pyramid, meta) pairs up to
    ``--max_pairs``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--snapshot", type=str, default=None)
    parser.add_argument("--test_epoch", type=int, default=None)
    parser.add_argument("--test_iter", type=int, default=None)
    parser.add_argument("--cfg_file", type=str, default=None,
                        help="JSON file of dotted config overrides")
    parser.add_argument("--benchmark", type=str, default=None)
    parser.add_argument("--max_pairs", type=int, default=None)
    parser.add_argument("--no_calibrate", action="store_true",
                        help="skip neighbor-limit calibration")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = serving_config(cfg)
    if args.cfg_file:
        with open(args.cfg_file) as f:
            cfg = apply_cfg_overrides(cfg, json.load(f))
    if not args.no_calibrate:
        cfg = with_calibrated_limits(cfg)
    benchmark = args.benchmark or cfg.data.benchmarks[0]
    test_ds = build_dataset(cfg, benchmark, training=False)  # raises for KITTI
    params = _load_params(cfg, _resolve_snapshot(cfg, args))
    tester = Tester(cfg.model, cfg.eval, cfg.output_dir, device=args.device)
    tester.build(params)

    return tester, pyramid_loader(test_ds, cfg, with_meta=True,
                                  limit=args.max_pairs or None), benchmark


def run_test(cfg: ExperimentConfig, argv=None):
    """Serve the benchmark's pairs through the eval forward and dump their
    features; returns the Tester's summary (mean metrics and
    ``seconds_per_pair``)."""
    tester, loader, benchmark = prepare_test(cfg, argv)
    return tester.run(loader, benchmark=benchmark)


def run_eval(cfg: ExperimentConfig, argv=None, pairwise: bool = False):
    """Offline evaluation of the dumps of :func:`run_test`; with
    ``pairwise=True``, the ``eval_dgr`` RRE/RTE acceptance protocol."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--benchmark", type=str, default=None)
    parser.add_argument("--method", type=str, default="lgr",
                        choices=["lgr", "ransac", "svd"])
    parser.add_argument("--num_corr", type=int, default=None,
                        help="keep only the top-N scoring correspondences")
    parser.add_argument("--test_epoch", type=int, default=None,
                        help="accepted for CLI parity (dumps are per benchmark)")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    benchmark = args.benchmark or cfg.data.benchmarks[0]
    gt_root = osp.join(cfg.data.dataset_root, "metadata", "benchmarks", benchmark)
    result = evaluate_benchmark(
        osp.join(cfg.output_dir, "features"), benchmark, method=args.method,
        acceptance_radius=cfg.eval.acceptance_radius,
        rmse_threshold=cfg.eval.rmse_threshold,
        rre_threshold=cfg.eval.rre_threshold,
        rte_threshold=cfg.eval.rte_threshold,
        kitti_registration=cfg.eval.kitti_registration,
        gt_root=gt_root if osp.isdir(gt_root) else None,
        ransac_kwargs=dict(
            distance_threshold=cfg.eval.ransac_distance_threshold,
            num_points=cfg.eval.ransac_num_points,
            num_iterations=cfg.eval.ransac_num_iterations,
        ),
        num_corr=args.num_corr,
        pairwise_registration=pairwise,
    )
    logger = get_logger()
    for scene, vals in result.items():
        logger.info(f"{scene}: " + ", ".join(f"{k}={v:.4f}" for k, v in vals.items()))
    return result


def run_eval_dgr(cfg: ExperimentConfig, argv=None):
    """The same dumps under the per-pair RRE/RTE acceptance of
    ``eval_dgr.py``."""
    return run_eval(cfg, argv, pairwise=True)


def run_demo(cfg: ExperimentConfig, argv=None):
    """Register one pair, then the same pair with its source rotated (the
    equivariance check), and write the original pair's PLYs.  Returns
    ``{"original": (RRE, RTE), "rotated src": (RRE, RTE)}`` in degrees and
    metres."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--snapshot", type=str, default=None)
    parser.add_argument("--src_file", type=str, default=None)
    parser.add_argument("--ref_file", type=str, default=None)
    parser.add_argument("--gt_file", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None,
                        help="where to write the demo PLYs (default <output_dir>/demo)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = serving_config(cfg)
    if not args.src_file:
        # a shipped demo pair (data/demo/{src,ref,gt}.npy) where there is one
        root = osp.join(osp.dirname(cfg.data.dataset_root), "demo")
        if osp.isfile(osp.join(root, "src.npy")):
            args.src_file = osp.join(root, "src.npy")
            args.ref_file = osp.join(root, "ref.npy")
            args.gt_file = osp.join(root, "gt.npy")
    if args.src_file and args.ref_file:
        src = np.load(args.src_file).astype(np.float32)
        ref = np.load(args.ref_file).astype(np.float32)
        gt = (np.load(args.gt_file).astype(np.float32) if args.gt_file
              else np.eye(4, dtype=np.float32))
    else:
        item = ds_lib.SyntheticPairDataset(num_pairs=1, seed=7)[0]
        ref, src, gt = item["ref_points"], item["src_points"], item["transform"]

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_demo: no CUDA device; pass --device cpu to run on the CPU")
    model = SE3ETModel(cfg.model, device=device).eval()
    model.load_state_dict(_load_params(cfg, args.snapshot))
    forward = make_forward(model)
    logger = get_logger()

    out_dir = args.out_dir or osp.join(cfg.output_dir, "demo")
    os.makedirs(out_dir, exist_ok=True)
    errors = {}
    for tag, rot in (("original", np.eye(3)),
                     ("rotated src", np.asarray(
                         ds_lib.random_sample_rotation_v2(np.random.RandomState(3))))):
        src_r = (src @ rot.T).astype(np.float32)
        gt_r = gt.copy()
        gt_r[:3, :3] = gt[:3, :3] @ rot.T
        data = build_pair(ref, src_r, gt_r, cfg.pipeline, cfg.model)
        out = forward(pyramid_to_tensors(data, device))
        rre, rte = se3.isotropic_transform_error(
            torch.as_tensor(gt_r, dtype=torch.float32, device=device),
            out["estimated_transform"])
        errors[tag] = (float(rre), float(rte))
        logger.info(f"demo [{tag}]: RRE {errors[tag][0]:.3f} deg, RTE {errors[tag][1]:.3f} m")
        if tag == "original":
            est = out["estimated_transform"].cpu().numpy()
            cv = out["corr_valid"].cpu().numpy()
            src_reg = src_r @ est[:3, :3].T + est[:3, 3]
            red = np.tile([[220, 60, 60]], (len(ref), 1)).astype(np.uint8)
            blue = np.tile([[60, 100, 220]], (len(src_r), 1)).astype(np.uint8)
            pc_io.write_ply(osp.join(out_dir, "pair_raw.ply"), np.concatenate([ref, src_r]),
                            np.concatenate([red, blue]))
            pc_io.write_ply(osp.join(out_dir, "pair_registered.ply"),
                            np.concatenate([ref, src_reg]), np.concatenate([red, blue]))
            pc_io.write_correspondence_ply(
                osp.join(out_dir, "correspondences.ply"),
                out["ref_corr_points"].cpu().numpy()[cv],
                out["src_corr_points"].cpu().numpy()[cv])
            logger.info(f"demo artifacts written to {out_dir}")
    return errors


COMMANDS = {"trainval": run_trainval, "test": run_test, "eval": run_eval,
            "eval_dgr": run_eval_dgr, "demo": run_demo}


def main(argv=None):
    """``<experiment> {trainval,test,eval,eval_dgr,demo} [command arguments]``."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[1] not in COMMANDS:
        raise SystemExit(f"usage: python -m se3et_tpu_torch.experiments.runner <experiment> "
                         f"{{{','.join(COMMANDS)}}} [arguments]")
    return COMMANDS[argv[1]](make_cfg(argv[0]), argv[2:])


if __name__ == "__main__":
    main()
