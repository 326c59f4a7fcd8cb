"""The PyTorch port's copies of the JAX package's numpy modules equal the
originals on seeded inputs: anchor tables, kernel-point dispositions, real
spherical harmonics and Wigner-D blocks, and one synthetic pyramid pair,
array for array.  (The port may import nothing of the JAX package, so it
keeps its own copies; these tests keep them true.)
"""

import dataclasses
import os

import numpy as np
import pytest

from se3et_tpu.core import anchors as j_anchors
from se3et_tpu.core import harmonics as j_harmonics
from se3et_tpu.core import kernel_points as j_kp
from se3et_tpu.data import datasets as j_datasets
from se3et_tpu.data import pipeline as j_pipeline
from se3et_tpu_torch.core import anchors, harmonics
from se3et_tpu_torch.core import kernel_points as kp
from se3et_tpu_torch.data import datasets, pipeline


@pytest.mark.parametrize("kanchor,quotient", [(1, 1), (3, 1), (4, 3), (6, 4), (12, 5)])
def test_anchor_space_matches(kanchor, quotient):
    want = j_anchors.get_anchor_space(kanchor, quotient)
    got = anchors.get_anchor_space(kanchor, quotient)
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if w is None:
            assert g is None, field.name
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=field.name)


@pytest.mark.parametrize("name", ["k_015_center_3D", "k_lloyd_045_center_3D",
                                  "k_lloyd_045_verticals_3D"])
def test_load_kernels_dispositions_match(name):
    """The three committed dispositions load to the same kernel points."""
    num = int(name.split("_")[-3])
    fixed = name.split("_")[-2]
    want = j_kp.load_kernels(1.0, num, dimension=3, fixed=fixed, seed=3)
    got = kp.load_kernels(1.0, num, dimension=3, fixed=fixed, seed=3)
    np.testing.assert_array_equal(got, want)


def test_equivariant_kernel_tables_match():
    want = j_kp.equivariant_kernel_points(0.0625, 15, 6, 4)
    got = kp.equivariant_kernel_points(0.0625, 15, 6, 4)
    np.testing.assert_array_equal(got, want)
    space, j_space = anchors.get_anchor_space(6, 4), j_anchors.get_anchor_space(6, 4)
    for g, w in zip(kp.kernel_permutation_tables(got, space),
                    j_kp.kernel_permutation_tables(want, j_space)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_harmonics_match():
    rng = np.random.RandomState(0)
    vec = rng.normal(size=(50, 3))
    np.testing.assert_array_equal(harmonics.real_sh([0, 1, 2], vec),
                                  j_harmonics.real_sh([0, 1, 2], vec))
    anc = j_anchors.get_anchor_space(6, 4).anchors
    for g, w in zip(harmonics.anchor_wigner_d([0, 1, 2], anc),
                    j_harmonics.anchor_wigner_d([0, 1, 2], anc)):
        np.testing.assert_array_equal(g, w)


def test_synthetic_pair_pyramid_matches():
    """SyntheticPairDataset seed 0 -> build_pair_pyramid: the same dict."""
    cfg = j_pipeline.PyramidConfig(
        num_stages=4, voxel_size=0.14, search_radius=0.35, neighbor_limits=(8, 8, 8, 8),
        stage_caps=(128, 64, 32, 24), coarse_point_cap=24, window_segments=0, patch_k=8)
    port_cfg = pipeline.PyramidConfig(**{f.name: getattr(cfg, f.name)
                                         for f in dataclasses.fields(cfg)})
    want_item = j_datasets.SyntheticPairDataset(num_pairs=1, num_points=400, seed=0)[0]
    got_item = datasets.SyntheticPairDataset(num_pairs=1, num_points=400, seed=0)[0]
    for key in ("ref_points", "src_points", "transform"):
        np.testing.assert_array_equal(got_item[key], want_item[key])
    want = j_pipeline.build_pair_pyramid(want_item["ref_points"], want_item["src_points"],
                                         want_item["transform"], cfg)
    got = pipeline.build_pair_pyramid(got_item["ref_points"], got_item["src_points"],
                                      got_item["transform"], port_cfg)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _body(module):
    """A module's source after its docstring."""
    import ast
    import inspect

    src = inspect.getsource(module)
    doc = ast.parse(src).body[0]
    return "".join(src.splitlines(keepends=True)[doc.end_lineno:])


@pytest.mark.parametrize("name", ["eval.benchmark", "utils.pointcloud_io", "utils.summary",
                                  "utils.metrics_writer"])
def test_copied_module_source_matches(name):
    """The port's copies of the numpy-only modules of the test and training
    paths equal the originals line for line after their docstrings, up to
    the summary module's ``get_logger``, which differs (its test follows)."""
    import importlib

    want = _body(importlib.import_module(f"se3et_tpu.{name}"))
    got = _body(importlib.import_module(f"se3et_tpu_torch.{name}"))
    if name == "utils.summary":
        want, got = (text.split("def get_logger(")[0] for text in (want, got))
    assert got == want


def test_get_logger_adds_the_file_after_an_earlier_call(tmp_path):
    """A logger first made without a directory logs to a file once a later
    call names one (as the runner logs before the ``Tester`` names its log
    directory), and to the newest directory named after that."""
    import logging

    from se3et_tpu_torch.utils import summary

    name = "se3et_tpu_torch.test_get_logger"
    logger = summary.get_logger(name=name)
    try:
        logger.info("before")
        assert summary.get_logger(str(tmp_path / "a"), name=name) is logger
        logger.info("first")
        summary.get_logger(str(tmp_path / "a"), name=name)  # no second file handler
        summary.get_logger(str(tmp_path / "b"), name=name)
        logger.info("second")
        files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        assert len(files) == 1
        files[0].flush()
        (a,), (b,) = (list((tmp_path / d).iterdir()) for d in ("a", "b"))
        assert "first" in a.read_text() and "second" not in a.read_text()
        assert "second" in b.read_text() and "before" not in b.read_text()
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


def test_copied_module_behaviour_matches(tmp_path):
    """The copies compute what the originals do on seeded inputs: the
    registration errors, inlier ratio, sparse precision, overlap, RANSAC, the
    log files, the PLY writers and the summary board."""
    from se3et_tpu.eval import benchmark as j_bench
    from se3et_tpu.utils import pointcloud_io as j_io
    from se3et_tpu.utils import summary as j_summary
    from se3et_tpu_torch.eval import benchmark
    from se3et_tpu_torch.utils import pointcloud_io, summary

    rng = np.random.RandomState(6)
    pts = rng.normal(size=(60, 3)).astype(np.float32)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = datasets.random_sample_rotation_v2(rng)
    tf[:3, 3] = rng.normal(size=3)
    est = tf.copy()
    est[:3, 3] += 0.05
    moved = pts @ tf[:3, :3].T + tf[:3, 3] + rng.normal(scale=0.03, size=pts.shape)
    for fn, args in (("compute_registration_error", (tf, est)),
                     ("compute_inlier_ratio", (moved, pts, tf, 0.05)),
                     ("compute_sparse_precision", (np.arange(6), np.arange(6) % 3,
                                                   np.stack([np.arange(3)] * 2, 1))),
                     ("compute_overlap", (moved, pts, tf, 0.05))):
        assert getattr(benchmark, fn)(*args) == getattr(j_bench, fn)(*args), fn
    np.testing.assert_array_equal(
        benchmark.registration_ransac_from_correspondences(moved, pts, num_iterations=300),
        j_bench.registration_ransac_from_correspondences(moved, pts, num_iterations=300))
    logs = [dict(test_pair=[0, 2], num_fragments=3, transform=est)]
    benchmark.write_log_file(str(tmp_path / "a" / "est.log"), logs)
    j_bench.write_log_file(str(tmp_path / "b" / "est.log"), logs)
    assert (tmp_path / "a" / "est.log").read_bytes() == (tmp_path / "b" / "est.log").read_bytes()
    colors = pointcloud_io.feature_colors(pts)
    np.testing.assert_array_equal(colors, j_io.feature_colors(pts))
    for mod, tag in ((pointcloud_io, "a"), (j_io, "b")):
        mod.write_ply(str(tmp_path / f"{tag}.ply"), pts, colors)
        mod.write_correspondence_ply(str(tmp_path / f"{tag}_c.ply"), moved, pts)
    for name in ("a.ply", "a_c.ply"):
        assert (tmp_path / name).read_bytes() == (tmp_path / name.replace("a", "b", 1)
                                                  ).read_bytes()
    boards = [summary.SummaryBoard(), j_summary.SummaryBoard()]
    for board in boards:
        for i in range(5):
            board.update_from_dict({"RR": i % 2, "RRE": 0.5 * i, "bad": "x"})
    assert boards[0].summary() == boards[1].summary() and "bad" not in boards[0].summary()


def test_calibrate_neighbor_limits_matches():
    """The port's ``calibrate_neighbor_limits`` gives JAX's widths on the same
    synthetic pairs."""
    cfg = j_pipeline.PyramidConfig(
        num_stages=4, voxel_size=0.1, search_radius=0.25, neighbor_limits=(8, 8, 8, 8),
        stage_caps=(512, 256, 128, 64), coarse_point_cap=64, window_segments=0)
    port_cfg = pipeline.PyramidConfig(**{f.name: getattr(cfg, f.name)
                                         for f in dataclasses.fields(cfg)})
    ds = datasets.SyntheticPairDataset(num_pairs=3, num_points=500, seed=2)
    sample = [(ds[i]["ref_points"], ds[i]["src_points"]) for i in range(3)]
    want = j_pipeline.calibrate_neighbor_limits(iter(sample), cfg)
    got = pipeline.calibrate_neighbor_limits(iter(sample), port_cfg)
    assert got == want and len(got) == 4


@pytest.mark.parametrize("rotated,augment", [(False, False), (True, False), (False, True)])
def test_threedmatch_dataset_matches(tmp_path, rotated, augment):
    """``ThreeDMatchPairDataset`` reads the same pairs as JAX's from metadata
    and clouds the test writes (``.npy`` and ``.pth``), with the full
    rotations of ``rotated`` and the training augmentation."""
    import pickle

    import torch

    rng = np.random.RandomState(7)
    os.makedirs(tmp_path / "metadata")
    os.makedirs(tmp_path / "data" / "scene")
    np.save(tmp_path / "data" / "scene" / "f0.npy", rng.normal(size=(300, 3)).astype(np.float32))
    torch.save(torch.from_numpy(rng.normal(size=(250, 3)).astype(np.float32)),
               tmp_path / "data" / "scene" / "f1.pth")
    meta = [dict(scene_name="scene", frag_id0=0, frag_id1=1, overlap=0.4 + 0.2 * i,
                 pcd0="scene/f0.npy", pcd1="scene/f1.pth",
                 rotation=j_datasets.random_sample_rotation_v2(rng),
                 translation=rng.normal(size=3)) for i in range(2)]
    with open(tmp_path / "metadata" / "3DMatch.pkl", "wb") as f:
        pickle.dump(meta, f)
    kwargs = dict(point_limit=200, use_augmentation=augment, rotated=rotated, seed=3)
    want = j_datasets.ThreeDMatchPairDataset(str(tmp_path), "3DMatch", **kwargs)
    got = datasets.ThreeDMatchPairDataset(str(tmp_path), "3DMatch", **kwargs)
    assert len(got) == len(want) == 2
    for i in range(2):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for key, val in w.items():
            if isinstance(val, np.ndarray):
                assert g[key].dtype == val.dtype, key
                np.testing.assert_array_equal(g[key], val, err_msg=key)
            else:
                assert g[key] == val, key
        assert g["ref_points"].shape == (200, 3)
