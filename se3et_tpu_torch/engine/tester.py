r"""Testing engine of the PyTorch port: per-pair inference with the in-graph
metrics, feature dumps, and the offline benchmark evaluation (port of
:mod:`se3et_tpu.engine.tester`).

* :class:`Tester` serves a dataset's pyramids through the eval forward
  (``make_forward(model, eval_cfg)``: the registration, the ground-truth
  overlaps and :func:`~se3et_tpu_torch.nn.loss.evaluate`'s metrics).  On
  the card it captures that forward into one CUDA graph at the first pair
  (:func:`~se3et_tpu_torch.engine.serving.capture_forward`) and replays it
  for every pair, as the JAX tester jits it; on the CPU, where the caller
  asks for it, it runs the forward eagerly.  Each pair is timed as copy-in
  + replay + synchronise, and the mean leaves out the first pair (the
  capture), as JAX's leaves out its compile.  It dumps one ``.npz`` per
  pair with the JAX tester's keys and dtypes, so each package's
  :func:`evaluate_benchmark` reads the other's dumps.
* :func:`evaluate_benchmark` replays the offline ``eval.py`` flow over the
  dumps: the correspondence metrics, the registration method
  (``lgr`` / ``ransac`` / ``svd``) and, where ``gt.log`` / ``gt.info``
  metadata is present, the 3DMatch scene recall.

There is no fallback: the JAX tester's ladder of serving configurations
(``serving_config_ladder`` / ``make_failsafe_forward``), which retries a
failed compile on another route, is not ported.  A failed build, launch or
capture raises.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from collections import defaultdict

import numpy as np
import torch

from se3et_tpu_torch.core import se3
from se3et_tpu_torch.data.influence import verify_influence
from se3et_tpu_torch.engine.serving import capture_forward
from se3et_tpu_torch.engine.steps import make_forward
from se3et_tpu_torch.eval import benchmark as bench_lib
from se3et_tpu_torch.nn import loss as loss_lib
from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors
from se3et_tpu_torch.utils.summary import SummaryBoard, get_logger


def _numpy(t):
    return t.detach().cpu().numpy()


class Tester:
    """Serves pairs through the eval forward and dumps their features.

    ``device`` is the card unless the caller asks for the CPU; without a
    CUDA device the default raises."""

    def __init__(self, model_cfg: ModelConfig, eval_cfg: loss_lib.EvalConfig,
                 output_dir: str, device="cuda"):
        self.model_cfg = model_cfg
        self.eval_cfg = eval_cfg
        self.output_dir = output_dir
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Tester: no CUDA device; pass device='cpu' to run on the CPU")
        self.feature_dir = osp.join(output_dir, "features")
        os.makedirs(self.feature_dir, exist_ok=True)
        self.logger = get_logger(osp.join(output_dir, "logs"))
        self.model = SE3ETModel(model_cfg, device=self.device).eval()
        self._forward = None
        self.captured = None

    def build(self, params: dict):
        """Load ``params`` (the model's ``state_dict``) and set up the eval
        forward: eager on the CPU, captured at the first pair on the card."""
        self.model.load_state_dict(params)
        self.captured = None
        if self.device.type == "cpu":
            self._forward = make_forward(self.model, self.eval_cfg)
        else:
            def forward(data):
                if self.captured is None:
                    self.captured = capture_forward(self.model, data, self.eval_cfg)
                return self.captured(data)

            self._forward = forward

    def run(self, loader, save_features: bool = True, benchmark: str = "test"):
        """``loader`` yields (numpy pyramid, meta) tuples; returns the mean
        of each metric and ``seconds_per_pair``."""
        if self._forward is None:
            raise RuntimeError("Tester.run: call build(params) first")
        board = SummaryBoard()
        times = []
        for i, (data, meta) in enumerate(loader):
            t0 = time.time()
            verify_influence(data, self.model_cfg, logger=self.logger)
            out = self._forward(pyramid_to_tensors(data, self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times.append(time.time() - t0)
            board.update_from_dict({k: float(v) for k, v in out["metrics"].items()})
            if save_features:
                self._save_pair(out, data, meta, benchmark, i)
            if (i + 1) % 10 == 0:
                self.logger.info(f"[{i + 1}] {board.format()} ({np.mean(times[1:]):.3f}s/pair)")
        summary = board.summary()
        summary["seconds_per_pair"] = float(np.mean(times[1:])) if len(times) > 1 else (
            float(times[0]) if times else 0.0)
        self.logger.info("test summary: " + str(summary))
        return summary

    def _save_pair(self, out, data, meta, benchmark, index):
        """One pair's dump, key for key and dtype for dtype the JAX
        tester's: node arrays in the padded node index space with the
        valid-node masks beside them, valid correspondences only."""
        scene = meta.get("scene_name") or meta.get("seq_id") or "scene"
        scene_dir = osp.join(self.feature_dir, benchmark, str(scene))
        os.makedirs(scene_dir, exist_ok=True)
        ref_frame = meta.get("ref_frame", index)
        src_frame = meta.get("src_frame", index)
        coarse = self.model_cfg.num_stages - 1
        cv = _numpy(out["corr_valid"])
        nv = _numpy(out["node_corr_valid"])
        gt_pairs = np.argwhere(
            _numpy(out["gt_overlap_mat"]) > self.eval_cfg.acceptance_overlap).astype(np.int32)
        masks_0 = np.asarray(data["masks_0"])
        np.savez_compressed(
            osp.join(scene_dir, f"{ref_frame}_{src_frame}.npz"),
            ref_points=np.asarray(data["points_0"][0])[masks_0[0]],
            src_points=np.asarray(data["points_0"][1])[masks_0[1]],
            ref_points_c=np.asarray(data[f"points_{coarse}"][0]),
            src_points_c=np.asarray(data[f"points_{coarse}"][1]),
            ref_node_masks=_numpy(out["ref_node_masks"]),
            src_node_masks=_numpy(out["src_node_masks"]),
            ref_feats_c=_numpy(out["ref_feats_c"]),
            src_feats_c=_numpy(out["src_feats_c"]),
            ref_node_corr_indices=_numpy(out["ref_node_corr_indices"]).astype(np.int32)[nv],
            src_node_corr_indices=_numpy(out["src_node_corr_indices"]).astype(np.int32)[nv],
            gt_node_corr_indices=gt_pairs,
            ref_corr_points=_numpy(out["ref_corr_points"])[cv],
            src_corr_points=_numpy(out["src_corr_points"])[cv],
            corr_scores=_numpy(out["corr_scores"])[cv],
            gt_transform=np.asarray(data["transform"]),
            estimated_transform=_numpy(out["estimated_transform"]),
            ref_frame=ref_frame,
            src_frame=src_frame,
            num_fragments=meta.get("num_fragments", 0),
        )


def evaluate_benchmark(
    feature_dir: str,
    benchmark: str,
    method: str = "lgr",
    acceptance_radius: float = 0.1,
    inlier_ratio_threshold: float = 0.05,
    rmse_threshold: float = 0.2,
    rre_threshold: float = 5.0,
    rte_threshold: float = 2.0,
    kitti_registration: bool = False,
    gt_root: str | None = None,
    ransac_kwargs: dict | None = None,
    num_corr: int | None = None,
    pairwise_registration: bool = False,
):
    """Offline evaluation over per-pair dumps (the JAX evaluator's protocol).

    ``method``: 'lgr' (the dumped transform), 'ransac' (RANSAC over the
    correspondences) or 'svd' (the weighted Procrustes of the
    correspondences by their scores, at its default method, Horn's, as the
    JAX evaluator computes it).

    3DMatch protocol (default): RR per pair is realignment RMSE below
    ``rmse_threshold``, scene-averaged, plus the official gt.log / gt.info
    scene recall where ``gt_root`` holds them.  KITTI protocol
    (``kitti_registration``): RR = (RRE < rre_threshold and RTE <
    rte_threshold), averaged over pairs with no scene grouping.
    ``num_corr`` keeps the top-scoring correspondences only;
    ``pairwise_registration`` takes the KITTI acceptance per pair but keeps
    the scene grouping (the ``eval_dgr.py`` protocol)."""
    root = osp.join(feature_dir, benchmark)
    scene_metrics = defaultdict(lambda: SummaryBoard())
    pair_board = SummaryBoard()  # KITTI protocol: pair-averaged, no scenes
    est_logs = defaultdict(list)

    for scene in sorted(os.listdir(root)):
        scene_dir = osp.join(root, scene)
        for fname in sorted(os.listdir(scene_dir)):
            d = np.load(osp.join(scene_dir, fname))
            ref_corr, src_corr = d["ref_corr_points"], d["src_corr_points"]
            scores = d["corr_scores"]
            if num_corr is not None and len(scores) > num_corr:
                sel = np.argsort(-scores)[:num_corr]
                ref_corr, src_corr, scores = ref_corr[sel], src_corr[sel], scores[sel]
            gt = d["gt_transform"]
            if method == "lgr":
                est = d["estimated_transform"]
            elif method == "ransac":
                est = bench_lib.registration_ransac_from_correspondences(
                    ref_corr, src_corr, **(ransac_kwargs or {}))
            elif method == "svd":
                est = se3.weighted_procrustes(
                    torch.from_numpy(src_corr), torch.from_numpy(ref_corr),
                    torch.from_numpy(scores)).numpy()
            else:
                raise ValueError(method)

            ir = bench_lib.compute_inlier_ratio(ref_corr, src_corr, gt, acceptance_radius)
            rre, rte = bench_lib.compute_registration_error(gt, est)
            board = scene_metrics[scene]
            if "gt_node_corr_indices" in d:
                pir = bench_lib.compute_sparse_precision(
                    d["ref_node_corr_indices"], d["src_node_corr_indices"],
                    d["gt_node_corr_indices"])
                board.update("PIR", pir)
                board.update("PMR>0", float(pir > 0))
                board.update("PMR>=0.1", float(pir >= 0.1))
                board.update("PMR>=0.3", float(pir >= 0.3))
                board.update("PMR>=0.5", float(pir >= 0.5))
            board.update("IR", ir)
            board.update("FMR", float(ir >= inlier_ratio_threshold))
            board.update("RRE", rre)
            board.update("RTE", rte)
            if kitti_registration:
                rr = float(rre < rre_threshold and rte < rte_threshold)
                board.update("RR", rr)
                if "gt_node_corr_indices" in d:
                    pair_board.update("PIR", pir)
                pair_board.update("IR", ir)
                pair_board.update("FMR", float(ir >= inlier_ratio_threshold))
                pair_board.update("RRE", rre)
                pair_board.update("RTE", rte)
                pair_board.update("RR", rr)
            elif pairwise_registration:
                board.update("RR", float(rre < rre_threshold and rte < rte_threshold))
            else:
                src_points = d["src_points"]
                realign = np.linalg.inv(gt) @ est
                moved = src_points @ realign[:3, :3].T + realign[:3, 3]
                rmse = float(np.linalg.norm(moved - src_points, axis=1).mean())
                board.update("RMSE", rmse)
                board.update("RR", float(rmse < rmse_threshold))
            est_logs[scene].append(dict(
                test_pair=[int(d["ref_frame"]), int(d["src_frame"])],
                num_fragments=int(d["num_fragments"]),
                transform=est,
            ))

    result = {scene: board.summary() for scene, board in scene_metrics.items()}
    if kitti_registration:
        result["overall"] = pair_board.summary()
        return result
    overall = SummaryBoard()
    for vals in result.values():
        for k, v in vals.items():
            overall.update(k, v)
    result["overall"] = overall.summary()

    if gt_root is not None and osp.isdir(gt_root):
        recalls = []
        for scene, logs in est_logs.items():
            gt_scene = osp.join(gt_root, scene)
            if not osp.isfile(osp.join(gt_scene, "gt.log")):
                continue
            est_file = osp.join(feature_dir, benchmark + "_est", scene, "est.log")
            bench_lib.write_log_file(est_file, logs)
            r = bench_lib.evaluate_registration_one_scene(
                osp.join(gt_scene, "gt.log"), osp.join(gt_scene, "gt.info"), est_file,
                positive_threshold=rmse_threshold)
            result[scene]["scene_recall"] = r["recall"]
            recalls.append(r["recall"])
        if recalls:
            result["overall"]["scene_recall"] = float(np.mean(recalls))
    return result
