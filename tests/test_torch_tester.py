"""The port's test path on the CPU: the ``Tester`` against JAX's on the same
weights and pairs (the dumps' keys, dtypes and shapes), both packages'
``evaluate_benchmark`` on each package's dumps (``lgr``, ``svd``, a seeded
``ransac``, the KITTI and ``eval_dgr`` protocols, ``num_corr`` and the
3DMatch scene recall from a ``gt.log`` / ``gt.info`` the test writes), and
the runner (``run_test`` / ``run_eval`` / ``run_demo``) at the tiny cut,
writing under ``tmp_path``.

Both testers serve the tiny materialised cut of ``__graft_entry__`` with
exact neighbours on two synthetic pairs without host influence: both
packages compute it in the forward.  Weights are drawn with numpy from a
seed into the flax tree and converted with ``se3et_tpu_torch.convert``.
"""

import dataclasses
import os
import os.path as osp
import pickle

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_model import _random_params

torch.set_num_threads(1)

# the pairs' metadata: one scene, non-consecutive fragments (the scene
# recall's gt pairs)
_META = ({"scene_name": "scene_a", "ref_frame": 0, "src_frame": 2, "num_fragments": 4},
         {"scene_name": "scene_a", "ref_frame": 1, "src_frame": 3, "num_fragments": 4})
# outputs whose length is the number of valid correspondences, which the
# registration's discrete decisions set (C9): compared by dtype and width
_RAGGED = ("ref_corr_points", "src_corr_points", "corr_scores")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both testers over the same two pairs on the same weights; returns
    their feature directories and summaries."""
    import __graft_entry__ as ge
    from se3et_tpu.engine.tester import Tester as JaxTester
    from se3et_tpu.experiments import make_cfg as jax_make_cfg
    from se3et_tpu.nn.model import SE3ETModel as JaxModel
    from se3et_tpu_torch.convert import load_flax_params
    from se3et_tpu_torch.engine.tester import Tester
    from se3et_tpu_torch.nn.epn import EPNConfig
    from se3et_tpu_torch.nn.loss import EvalConfig
    from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel

    _, pipeline, jcfg = ge._flagship_configs(tiny=True)
    pipeline = dataclasses.replace(pipeline, patch_k=jcfg.num_points_in_patch)
    jcfg = dataclasses.replace(jcfg, serve_fused_embedding=False)
    jeval = jax_make_cfg("se3ete.3dmatch").eval
    pairs = [ge._example_pair(pipeline, num_points=250, seed=7 + i) for i in range(2)]
    jmodel = JaxModel(jcfg)
    rngs = {"params": jax.random.PRNGKey(0), "targets": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda d: jmodel.init(rngs, d, train=False, with_gt=False,
                                                  with_registration=False), pairs[0])
    params = _random_params(shapes, seed=8)

    root = tmp_path_factory.mktemp("testers")
    jax_tester = JaxTester(jcfg, jeval, str(root / "jax"))
    jax_tester.build(params)
    jax_summary = jax_tester.run(((dict(p), m) for p, m in zip(pairs, _META)),
                                 benchmark="3DMatch")

    fields = dataclasses.asdict(jcfg)
    fields["epn"] = EPNConfig(**fields["epn"])
    model_cfg = ModelConfig(**fields)
    weights = SE3ETModel(model_cfg, device="cpu")
    load_flax_params(weights, params)
    tester = Tester(model_cfg, EvalConfig(**dataclasses.asdict(jeval)), str(root / "port"),
                    device="cpu")
    tester.build(weights.state_dict())
    summary = tester.run(((dict(p), m) for p, m in zip(pairs, _META)), benchmark="3DMatch")
    return {"jax": str(root / "jax" / "features"), "port": str(root / "port" / "features"),
            "jax_summary": jax_summary, "summary": summary, "root": root}


def _files(feature_dir):
    base = osp.join(feature_dir, "3DMatch")
    return sorted(osp.join(scene, f) for scene in os.listdir(base)
                  for f in os.listdir(osp.join(base, scene)))


def test_tester_dumps_match_jax_keys_dtypes_and_shapes(dumps):
    """The eager CPU Tester writes one dump per pair, as JAX's does, with the
    same file names, keys and dtypes, and the same shapes (the valid
    correspondences of ``_RAGGED``: the same dtype and width)."""
    files = _files(dumps["port"])
    assert files == _files(dumps["jax"]) == ["scene_a/0_2.npz", "scene_a/1_3.npz"]
    for name in files:
        got = np.load(osp.join(dumps["port"], "3DMatch", name))
        want = np.load(osp.join(dumps["jax"], "3DMatch", name))
        assert sorted(got.files) == sorted(want.files), name
        for key in want.files:
            assert got[key].dtype == want[key].dtype, (name, key)
            if key in _RAGGED:
                assert got[key].shape[1:] == want[key].shape[1:], (name, key)
            else:
                assert got[key].shape == want[key].shape, (name, key)
        for key in ("ref_points", "src_points", "gt_transform", "ref_node_masks",
                    "gt_node_corr_indices", "ref_frame", "num_fragments"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_tester_summary_matches_jax(dumps):
    """The summaries hold the same metrics, all finite, and the same
    coarse precision (the coarse correspondences are the same sets)."""
    got, want = dumps["summary"], dumps["jax_summary"]
    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())
    np.testing.assert_allclose(got["PIR"], want["PIR"], rtol=0, atol=1e-5)


def _write_gt(root, feature_dir):
    """gt.log / gt.info of scene_a: the pair (0, 2) at the dumped estimate
    (so its registration counts as recalled), (1, 3) at its ground truth."""
    from se3et_tpu_torch.eval import benchmark

    d0 = np.load(osp.join(feature_dir, "3DMatch", "scene_a", "0_2.npz"))
    d1 = np.load(osp.join(feature_dir, "3DMatch", "scene_a", "1_3.npz"))
    gt_root = osp.join(root, "gt")
    benchmark.write_log_file(osp.join(gt_root, "scene_a", "gt.log"), [
        dict(test_pair=[0, 2], num_fragments=4, transform=d0["estimated_transform"]),
        dict(test_pair=[1, 3], num_fragments=4, transform=d1["gt_transform"])])
    with open(osp.join(gt_root, "scene_a", "gt.info"), "w") as f:
        for pair in ((0, 2), (1, 3)):
            f.write(f"{pair[0]}\t{pair[1]}\t4\n")
            f.writelines("\t".join(str(float(i == j)) for j in range(6)) + "\n"
                         for i in range(6))
    return gt_root


_CASES = {
    "lgr": dict(method="lgr"),
    "svd": dict(method="svd"),
    "ransac": dict(method="ransac", ransac_kwargs=dict(distance_threshold=0.05,
                                                       num_points=3, num_iterations=600)),
    "kitti": dict(method="lgr", acceptance_radius=1.0, rre_threshold=170.0,
                  rte_threshold=2.0, kitti_registration=True),
    "eval_dgr": dict(method="svd", rre_threshold=170.0, rte_threshold=2.0,
                     pairwise_registration=True),
    "num_corr": dict(method="svd", num_corr=5),
    "scene_recall": dict(method="lgr"),
}


@pytest.mark.parametrize("source,case", [(s, c) for s in ("port", "jax")
                                         for c in ("lgr", "svd", "ransac")]
                         + [("port", c) for c in ("kitti", "eval_dgr", "num_corr",
                                                  "scene_recall")])
def test_evaluate_benchmark_matches_jax(dumps, source, case):
    """Both packages' ``evaluate_benchmark`` on the same dumps (the port's,
    and for the three methods JAX's too: each package reads the other's)
    give the same scenes and metrics within 1e-6."""
    from se3et_tpu.engine.tester import evaluate_benchmark as jax_evaluate
    from se3et_tpu_torch.engine.tester import evaluate_benchmark

    kwargs = dict(_CASES[case])
    if case == "scene_recall":
        kwargs["gt_root"] = _write_gt(str(dumps["root"] / f"gt_{source}"), dumps[source])
    want = jax_evaluate(dumps[source], "3DMatch", **kwargs)
    got = evaluate_benchmark(dumps[source], "3DMatch", **kwargs)
    assert set(got) == set(want) == {"scene_a", "overall"}
    for scene, vals in want.items():
        assert set(got[scene]) == set(vals), scene
        for key, val in vals.items():
            np.testing.assert_allclose(got[scene][key], val, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{scene} {key}")
    if case == "scene_recall":
        assert got["overall"]["scene_recall"] == 0.5
    if case in ("kitti", "eval_dgr"):
        assert "RMSE" not in got["overall"] and "RR" in got["overall"]


def _tiny_experiment(tmp_path, monkeypatch, name="se3eti.3dmatch"):
    """The tiny cut of a registered experiment with its data root and
    output directory under ``tmp_path``, 250-point synthetic pairs."""
    from se3et_tpu_torch.experiments import configs

    cfg = configs.tiny_config(configs.make_cfg(name))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dataset_root=str(tmp_path / "data" / "3DMatch"), point_limit=250))
    outdir = str(tmp_path / "output")
    monkeypatch.setattr(configs.ExperimentConfig, "output_dir",
                        property(lambda self: outdir))
    return cfg, outdir


def test_runner_test_eval_and_demo_on_the_cpu(tmp_path, monkeypatch):
    """``run_test`` serves two synthetic pairs of the tiny SE3ET-I cut on the
    CPU with calibrated limits (cached), dumps them and writes its log, and
    ``run_eval`` / ``run_eval_dgr`` / ``run_demo`` run over them: finite
    metrics, the demo's PLYs and its two (RRE, RTE)."""
    from se3et_tpu_torch.experiments import runner

    cfg, outdir = _tiny_experiment(tmp_path, monkeypatch)
    summary = runner.run_test(cfg, ["--max_pairs", "2", "--device", "cpu"])
    assert {"PIR", "IR", "RRE", "RTE", "RMSE", "RR", "seconds_per_pair"} <= set(summary)
    assert all(np.isfinite(v) for v in summary.values())
    assert osp.isfile(osp.join(outdir, "neighbor_limits.json"))
    assert len(_files(osp.join(outdir, "features"))) == 2
    # the Tester's log file, although the runner logged before it was built
    (log,) = os.listdir(osp.join(outdir, "logs"))
    with open(osp.join(outdir, "logs", log)) as f:
        assert "test summary" in f.read()
    for argv in (["--method", "lgr"], ["--method", "svd"],
                 ["--method", "ransac", "--num_corr", "8"]):
        result = runner.run_eval(cfg, argv)
        assert np.isfinite(result["overall"]["RRE"]) and "RMSE" in result["overall"]
    dgr = runner.run_eval_dgr(cfg, ["--method", "svd"])
    assert "RR" in dgr["overall"] and "RMSE" not in dgr["overall"]
    errors = runner.run_demo(cfg, ["--device", "cpu"])
    assert set(errors) == {"original", "rotated src"}
    assert all(np.isfinite(v) for pair in errors.values() for v in pair)
    for f in ("pair_raw.ply", "pair_registered.ply", "correspondences.ply"):
        assert osp.isfile(osp.join(outdir, "demo", f)), f


@pytest.mark.parametrize("argv", [["--snapshot", "snap"], ["--test_epoch", "3"],
                                  ["--test_iter", "10"]])
def test_runner_refuses_snapshots(tmp_path, monkeypatch, argv):
    """The port reads its own snapshots only: a snapshot of the JAX package
    (an orbax directory, written here by the JAX trainer's checkpointer) at
    the path ``--snapshot`` / ``--test_epoch`` / ``--test_iter`` names
    raises ``NotImplementedError`` naming the importer still to come
    (``run_test``, and ``run_demo`` for ``--snapshot``); a path with no
    snapshot raises ``FileNotFoundError``."""
    import orbax.checkpoint as ocp

    from se3et_tpu_torch.experiments import runner

    cfg, outdir = _tiny_experiment(tmp_path, monkeypatch)
    with pytest.raises(FileNotFoundError, match="no snapshot"):
        runner.run_test(cfg, argv + ["--no_calibrate", "--device", "cpu"])
    snap_dir = osp.join(outdir, "snapshots")
    path = {"--snapshot": str(tmp_path / "snap"), "--test_epoch": osp.join(snap_dir, "epoch-3"),
            "--test_iter": osp.join(snap_dir, "iter-10")}[argv[0]]
    if argv[0] == "--snapshot":
        argv = ["--snapshot", path]
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(osp.abspath(path), {"params": {"w": np.ones((2, 3), np.float32)}, "epoch": 3,
                                   "iteration": 10})
    ckptr.wait_until_finished()
    with pytest.raises(NotImplementedError, match="orbax snapshots .*A5"):
        runner.run_test(cfg, argv + ["--no_calibrate", "--device", "cpu"])
    if argv[0] == "--snapshot":
        with pytest.raises(NotImplementedError, match="orbax snapshots .*A5"):
            runner.run_demo(cfg, argv + ["--device", "cpu"])


def test_runner_and_tester_need_cuda_unless_asked(tmp_path, monkeypatch):
    """The Tester, ``run_test`` and ``run_demo`` run on the card unless the
    caller asks for the CPU: without a CUDA device their defaults raise."""
    from se3et_tpu_torch.engine.tester import Tester
    from se3et_tpu_torch.experiments import runner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, outdir = _tiny_experiment(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tester(cfg.model, cfg.eval, outdir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_test(cfg, ["--no_calibrate", "--max_pairs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_demo(cfg, [])


def test_build_dataset_and_calibration_cache(tmp_path, monkeypatch):
    """``build_dataset`` falls back to the synthetic generator without
    metadata, loads 3DMatch where its metadata exists and refuses the
    unported KITTI loader; ``with_calibrated_limits`` equals JAX's on the
    same pairs and reads its cache back."""
    import json

    from se3et_tpu.data.pipeline import PyramidConfig as JaxPyramidConfig
    from se3et_tpu.data.pipeline import calibrate_neighbor_limits as jax_calibrate
    from se3et_tpu_torch.data import datasets
    from se3et_tpu_torch.experiments import runner

    cfg, outdir = _tiny_experiment(tmp_path, monkeypatch)
    ds = runner.build_dataset(cfg, "train", training=True)
    assert isinstance(ds, datasets.SyntheticPairDataset)
    assert (len(ds), ds.num_points) == (32, 250)
    cal = runner.with_calibrated_limits(cfg, max_pairs=2)
    jpipe = JaxPyramidConfig(**dataclasses.asdict(cfg.pipeline))
    want = jax_calibrate(((ds[i]["ref_points"], ds[i]["src_points"]) for i in range(2)),
                         jpipe)
    assert cal.pipeline.neighbor_limits == want
    with open(osp.join(outdir, "neighbor_limits.json")) as f:
        assert tuple(json.load(f)) == want
    poisoned = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="kitti"))
    assert runner.with_calibrated_limits(poisoned).pipeline.neighbor_limits == want

    root = tmp_path / "data" / "3DMatch"
    os.makedirs(root / "metadata")
    os.makedirs(root / "data")
    pts = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    np.save(root / "data" / "frag0.npy", pts)
    meta = [dict(overlap=0.6, pcd0="frag0.npy", pcd1="frag0.npy", scene_name="s",
                 frag_id0=0, frag_id1=1, rotation=np.eye(3), translation=np.zeros(3))]
    with open(root / "metadata" / "train.pkl", "wb") as f:
        pickle.dump(meta, f)
    ds = runner.build_dataset(cfg, "train", training=False)
    assert isinstance(ds, datasets.ThreeDMatchPairDataset)
    assert ds[0]["ref_points"].shape == (50, 3)
    kitti = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="kitti",
                                                              dataset_root=str(root)))
    with pytest.raises(NotImplementedError, match="kitti"):
        runner.build_dataset(kitti, "train", training=True)


def test_cfg_overrides_and_cli_usage(tmp_path, monkeypatch):
    """Dotted overrides reach the frozen tree; the CLI names its commands."""
    from se3et_tpu_torch.experiments import runner

    cfg, _ = _tiny_experiment(tmp_path, monkeypatch)
    got = runner.apply_cfg_overrides(cfg, {"model.fine_topk": 2, "eval.rmse_threshold": 0.3})
    assert (got.model.fine_topk, got.eval.rmse_threshold) == (2, 0.3)
    assert got.pipeline == cfg.pipeline
    with pytest.raises(SystemExit, match="test,eval,eval_dgr,demo"):
        runner.main(["se3eti.3dmatch", "train"])
