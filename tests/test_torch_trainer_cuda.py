"""The port's training engine on the card: one ``Trainer`` epoch of the tiny
se3ete2 flash cut (head width 32) with the training routes on, so that the
backward kernels run at the family's head width (K11 on its first design),
validation, snapshots and a resume; and the runner's ``trainval`` then
``test --snapshot`` on the card.
Skipped where no CUDA device is present; run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_trainer_cuda.py``.
"""

import dataclasses
import math
import os
import os.path as osp

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tiny_se3ete2(tmp_path, train_routes=True):
    """se3ete2.3dmatch's tiny flash cut (head width 32; with the training
    routes on where asked) reading 600-point synthetic pairs, its output
    under ``tmp_path``."""
    from se3et_tpu_torch.experiments import configs

    cfg = configs.tiny_flash_config(configs.make_cfg("se3ete2.3dmatch"))
    model = dataclasses.replace(cfg.model, train_fused_conv=train_routes,
                                train_fused_embedding=train_routes,
                                train_fused_attention=train_routes)
    return dataclasses.replace(cfg, model=model, data=dataclasses.replace(
        cfg.data, dataset_root=str(tmp_path / "data" / "3DMatch"), point_limit=600))


def test_trainer_epoch_on_the_card(cuda, tmp_path):
    """One epoch of two steps on the card: finite losses, no step skipped,
    the backward kernels K8-K11 launched (K11 on its "cuda" form at head
    width 32), validation metrics finite, the snapshots written; a trainer
    loaded from ``latest`` by default holds the same weights, epoch and
    iteration with a fresh optimizer."""
    from se3et_tpu_torch.engine.trainer import Trainer
    from se3et_tpu_torch.experiments import runner
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe
    from se3et_tpu_torch.ops.kernels import selfcheck

    cfg = _tiny_se3ete2(tmp_path)
    m = cfg.model
    assert rpe.rpe_attention_bwd_form(m.kanchor * m.num_heads, m.gt_hidden_dim // m.num_heads,
                                      m.gt_hidden_dim, torch.float32) == "cuda"
    train = list(runner.pyramid_loader(runner.build_dataset(cfg, "train", True), cfg, limit=2))
    val = list(runner.pyramid_loader(runner.build_dataset(cfg, "val", False), cfg, limit=1))
    optim = dataclasses.replace(cfg.optim, max_epoch=1)
    trainer = Trainer(m, cfg.loss, cfg.eval, optim, str(tmp_path / "out"), seed=cfg.seed,
                      log_steps=1)
    assert trainer.device.type == "cuda"
    trainer.initialize(None, steps_per_epoch=2)
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    summary = trainer.train_epoch(iter(train))
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    assert all(math.isfinite(v) for v in summary.values()), summary
    assert summary["skipped"] == 0.0
    assert all(launches[n] > 0 for n in selfcheck.TRAINING), launches
    val_summary = trainer.validate(iter(val))
    assert all(math.isfinite(v) for v in val_summary.values()), val_summary
    trainer.save_snapshot("latest")
    loaded = Trainer(m, cfg.loss, cfg.eval, optim, str(tmp_path / "out"), seed=cfg.seed + 1)
    loaded.initialize(None, steps_per_epoch=2)
    loaded.load_snapshot("latest")
    assert (loaded.epoch, loaded.iteration) == (trainer.epoch, trainer.iteration) == (0, 2)
    want = trainer.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in loaded.model.state_dict().items())
    assert loaded.optimizer.optimizer.state_dict()["state"] == {}


def test_trainval_then_test_on_the_card(cuda, tmp_path, monkeypatch):
    """``trainval`` (one epoch of one step, validation on one pair,
    snapshots), ``--resume`` to epoch 2, then ``test --snapshot
    .../latest``: the Tester on the card serves the trained weights through
    the captured eval forward, with finite metrics."""
    from se3et_tpu_torch.experiments import configs, runner

    cfg = _tiny_se3ete2(tmp_path, train_routes=False)
    outdir = str(tmp_path / "output")
    monkeypatch.setattr(configs.ExperimentConfig, "output_dir", property(lambda self: outdir))
    argv = ["--max_steps_per_epoch", "1", "--no_calibrate"]
    trainer = runner.run_trainval(cfg, ["--max_epoch", "1"] + argv)
    resumed = runner.run_trainval(cfg, ["--max_epoch", "2", "--resume"] + argv)
    assert (trainer.epoch, resumed.epoch, resumed.iteration) == (1, 2, 2)
    assert sorted(os.listdir(osp.join(outdir, "snapshots"))) == ["epoch-1", "epoch-2", "latest"]
    tester, loader, benchmark = runner.prepare_test(
        cfg, ["--snapshot", osp.join(outdir, "snapshots", "latest"), "--max_pairs", "2",
              "--no_calibrate"])
    want = resumed.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in tester.model.state_dict().items())
    summary = tester.run(loader, benchmark=benchmark)
    assert tester.captured is not None
    assert all(math.isfinite(v) for v in summary.values()), summary
