"""The PyTorch port's training engine against the JAX package's, on the CPU.

* Gradient accumulation: the port's ``make_train_step`` over its
  ``Optimizer`` with ``grad_acc_steps`` 2 against the JAX
  ``make_train_step`` over ``optax.MultiSteps(adamw)`` on the same linear
  model and data, across an epoch boundary of the schedule and through a
  non-finite micro-step.
* ``make_batched_train_step`` against JAX's on two pairs of the tiny
  se3eti2 cut, and on one pair padded with a weight-0 pair; the padded
  step equals the single-pair step bit for bit.
* The ``Trainer`` on the tiny se3eti2 cut: two epochs of two steps with
  validation (``events.jsonl`` in the JAX trainer's format), a resume from
  ``latest`` with the optimizer restored that reproduces the uninterrupted
  run bit for bit, the default resume (a fresh optimizer) against the JAX
  trainer's ``load_snapshot``, pair batching, and the refusals.
* The runner: ``trainval`` then ``test --snapshot .../latest`` with
  ``--device cpu`` (the JAX package's ``tests/test_runner.py`` roundtrip).

Torch cannot reproduce ``jax.random``: where the JAX model samples targets,
both sides get one fixed numpy Gumbel array (on the JAX side by patching
``jax.random.gumbel``), as in ``tests/test_torch_training.py``.
"""

import dataclasses
import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_training import _grab_grads, _random_params

torch.set_num_threads(1)


# --------------------------------------------------------- accumulation
class _TorchLinear(torch.nn.Module):
    """A stand-in for the model: ``pred = x @ w + b``."""

    def __init__(self, p0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))

    def forward(self, data, train=False, with_registration=True, generator=None,
                target_noise=None):
        return {"pred": data["x"] @ self.w + self.b}


class _JaxLinear:
    def apply(self, p, data, train=False, with_registration=True, rngs=None):
        return {"pred": data["x"] @ p["w"] + p["b"]}


def _mse_losses(xp):
    def overall_loss(out, data, cfg):
        total = xp.mean((out["pred"] - data["y"]) ** 2)
        return total, {"c_loss": total, "f_loss": 0.0 * total, "loss": total}

    return overall_loss


@pytest.mark.parametrize("clip", [None, 0.5])
def test_accumulation_matches_optax_multisteps(monkeypatch, clip):
    """Seven micro-steps at ``grad_acc_steps`` 2 through both packages'
    ``make_train_step`` (lr decay 0.5 an epoch, 2 steps an epoch, weight
    decay 0.1; without and with clipping at 0.5), the fourth with an
    infinite input, so its gradient norm is not finite.  After every
    micro-step the parameters agree to 1e-6; the skipped micro-step leaves
    the accumulator and its count as they were on both sides (JAX keeps the
    old ``MultiSteps`` state with ``where(ok, new, old)``); six real
    micro-steps make three updates, and the schedule counts those updates
    (its epoch advances after two of them, i.e. four micro-steps: JAX's
    schedule counts the inner optimizer's updates, not micro-steps)."""
    from se3et_tpu.engine import steps as jsteps
    from se3et_tpu.engine.trainer import OptimConfig as JaxOptim
    from se3et_tpu.engine.trainer import make_optimizer as jax_make_optimizer
    from se3et_tpu.nn import loss as jloss
    from se3et_tpu_torch.engine import steps
    from se3et_tpu_torch.engine.trainer import OptimConfig, make_optimizer
    from se3et_tpu_torch.nn import loss as tloss

    monkeypatch.setattr(jloss, "overall_loss", _mse_losses(jnp))
    monkeypatch.setattr(tloss, "overall_loss", _mse_losses(torch))
    rng = np.random.RandomState(12)
    p0 = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    batches = [{"x": rng.randn(4, 5).astype(np.float32),
                "y": rng.randn(4, 3).astype(np.float32)} for _ in range(7)]
    batches[3]["x"][1, 2] = np.inf
    fields = dict(lr=1e-2, lr_decay=0.5, lr_decay_steps=1, weight_decay=0.1,
                  grad_acc_steps=2, max_grad_norm=clip)
    tx = jax_make_optimizer(JaxOptim(**fields), steps_per_epoch=2)
    assert isinstance(tx, optax.MultiSteps)
    jstep = jax.jit(jsteps.make_train_step(_JaxLinear(), jloss.LossConfig(), tx))
    jp, state = {k: jnp.asarray(v) for k, v in p0.items()}, tx.init(p0)
    model = _TorchLinear(p0)
    opt = make_optimizer(model.parameters(), OptimConfig(**fields), steps_per_epoch=2)
    step = steps.make_train_step(model, tloss.LossConfig(), opt)
    named = dict(model.named_parameters())
    for i, batch in enumerate(batches):
        jp, new_state, jl = jstep(jp, state, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(i))
        tl = step({k: torch.from_numpy(v) for k, v in batch.items()})
        assert np.isfinite(float(jl["grad_norm"])) == bool(torch.isfinite(tl["grad_norm"])) \
            == (i != 3)
        if i == 3:  # the accumulator and its count are left as they were
            assert int(new_state.mini_step) == int(state.mini_step) == opt.mini_step == 1
        state = new_state
        assert opt.mini_step == int(state.mini_step)
        for name, acc in zip(("w", "b"), opt.acc):
            np.testing.assert_allclose(acc.numpy(), np.asarray(state.acc_grads[name]),
                                       rtol=0, atol=1e-6)
        for name in ("w", "b"):
            np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(jp[name]),
                                       rtol=0, atol=1e-6, err_msg=f"micro-step {i}: {name}")
    assert int(state.gradient_step) == opt.scheduler.last_epoch == 3
    # the third update took the decayed rate: epoch 1 of the schedule
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.5)


def test_optimizer_state_dict_round_trips_the_accumulator():
    """``Optimizer.state_dict`` carries AdamW, the schedule and the
    accumulator mid-way; loading it into a fresh optimizer continues the
    same way bit for bit."""
    from se3et_tpu_torch.engine.trainer import OptimConfig, make_optimizer

    rng = np.random.RandomState(13)
    p0 = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    cfg = OptimConfig(lr=1e-2, grad_acc_steps=2)
    runs = []
    for split in (None, 3):
        model = _TorchLinear(p0)
        opt = make_optimizer(model.parameters(), cfg, 2)
        for i, g in enumerate(grads):
            if i == split:
                state = opt.state_dict()
                model = _TorchLinear({k: v.detach().numpy() for k, v
                                      in model.named_parameters()})
                opt = make_optimizer(model.parameters(), cfg, 2)
                opt.load_state_dict(state)
            for name, p in model.named_parameters():
                p.grad = torch.from_numpy(g[name].copy())
            opt.step()
        runs.append({k: v.detach().clone() for k, v in model.named_parameters()})
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])


# ----------------------------------------------------------- batched step
@pytest.fixture(scope="module")
def batched():
    """Two tiny se3eti2 pairs (the materialised cut, 250 points, float32
    host influence) through both packages' ``make_batched_train_step`` on
    the same numpy weights and Gumbel noise, with pair weights (1, 1) and
    (1, 0); and the port's single-pair step on pair 0."""
    import __graft_entry__ as ge
    from se3et_tpu.engine.steps import make_batched_train_step as jax_batched
    from se3et_tpu.nn import loss as jloss
    from se3et_tpu.nn.model import SE3ETModel as JaxModel
    from se3et_tpu_torch.convert import flax_to_state_dict, load_flax_params
    from se3et_tpu_torch.engine.steps import make_batched_train_step, make_train_step
    from se3et_tpu_torch.engine.trainer import OptimConfig, make_optimizer, stack_pairs
    from se3et_tpu_torch.nn.epn import EPNConfig
    from se3et_tpu_torch.nn.loss import LossConfig
    from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors
    from tests.test_torch_wide_head import _jax_tiny

    jcfg, pipeline = _jax_tiny("se3eti2.3dmatch", flash=False)
    pairs = []
    for seed in (0, 1):
        data = ge._example_pair(pipeline, num_points=250, seed=seed, model_cfg=jcfg)
        pairs.append({k: (np.asarray(v, np.float32)
                          if k.startswith("influence_") and k != "influence_sig" else v)
                      for k, v in data.items()})
    n_coarse = pairs[0]["points_3"].shape[1]
    noise = np.random.RandomState(21).gumbel(size=(n_coarse, n_coarse)).astype(np.float32)
    jmodel = JaxModel(jcfg)
    rngs = {"params": jax.random.PRNGKey(0), "targets": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda d: jmodel.init(rngs, d, train=True,
                                                  with_registration=False), pairs[0])
    params = _random_params(shapes, seed=3)
    batch = stack_pairs(pairs)
    jstep = jax.jit(jax_batched(jmodel, jloss.LossConfig(), _grab_grads()))
    fields = dataclasses.asdict(jcfg)
    fields["epn"] = EPNConfig(**fields["epn"])
    port_cfg = ModelConfig(**fields)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32:
                   jnp.asarray(noise, dtype))
        for tag, weights in (("two", (1.0, 1.0)), ("padded", (1.0, 0.0))):
            jb = dict(batch, pair_weights=np.asarray(weights, np.float32))
            _, jgrads, jlosses = jstep(params, _grab_grads().init(params), jb,
                                       jax.random.PRNGKey(2))
            port = load_flax_params(SE3ETModel(port_cfg, device="cpu"), params)
            opt = make_optimizer(port.parameters(), OptimConfig(), 10)
            tb = pyramid_to_tensors(batch, "cpu")
            if tag == "padded":
                tb["pair_weights"] = torch.tensor(weights)
            tnoise = torch.from_numpy(np.stack([noise, noise]))
            losses = make_batched_train_step(port, LossConfig(), opt)(tb, target_noise=tnoise)
            out[tag] = {
                "jax": {"losses": jax.tree.map(float, jlosses),
                        "grads": flax_to_state_dict(jax.tree.map(np.array, jgrads))},
                "port": {"losses": {k: float(v) for k, v in losses.items()},
                         "grads": {n: p.grad.clone() for n, p in port.named_parameters()},
                         "params": {n: p.detach().clone()
                                    for n, p in port.named_parameters()}}}
    single = load_flax_params(SE3ETModel(port_cfg, device="cpu"), params)
    opt = make_optimizer(single.parameters(), OptimConfig(), 10)
    losses = make_train_step(single, LossConfig(), opt)(
        pyramid_to_tensors(pairs[0], "cpu"), target_noise=torch.from_numpy(noise))
    out["single"] = {"losses": {k: float(v) for k, v in losses.items()},
                     "params": {n: p.detach().clone() for n, p in single.named_parameters()}}
    return out


@pytest.mark.parametrize("case", ["two", "padded"])
def test_batched_step_matches_jax(batched, case):
    """The weighted mean losses (rtol 1e-3), the gradient norm (rtol 1e-3)
    and every parameter's gradient by name (5e-2 of its norm + 5e-5, 1e-2
    over all of them: tests/test_torch_training.py's tolerance) of the
    batched step, on two pairs and on one pair padded at weight 0."""
    want, got = batched[case]["jax"], batched[case]["port"]
    for name in ("c_loss", "f_loss", "loss", "grad_norm"):
        np.testing.assert_allclose(got["losses"][name], want["losses"][name], rtol=1e-3,
                                   err_msg=name)
    assert set(got["grads"]) == set(want["grads"])
    bad, err2, ref2 = [], 0.0, 0.0
    for name, w in want["grads"].items():
        err = float(torch.linalg.norm(got["grads"][name] - w))
        ref = float(torch.linalg.norm(w))
        err2, ref2 = err2 + err**2, ref2 + ref**2
        if not err <= 5e-2 * ref + 5e-5:
            bad.append((name, err, ref))
    assert not bad, bad
    assert err2**0.5 <= 1e-2 * ref2**0.5


def test_padded_batch_equals_the_single_pair_step(batched):
    """A pair of weight 0 contributes exactly nothing: the batch of pair 0
    and a weight-0 pair gives the losses, gradient norm and updated
    parameters of the single-pair step on pair 0 bit for bit, while the
    unpadded batch differs."""
    padded, single = batched["padded"]["port"], batched["single"]
    assert padded["losses"] == single["losses"]
    for name, p in single["params"].items():
        assert torch.equal(padded["params"][name], p), name
    assert batched["two"]["port"]["losses"]["loss"] != single["losses"]["loss"]


# ---------------------------------------------------------------- trainer
def _tiny(tmp_path):
    from se3et_tpu_torch.experiments import configs

    cfg = configs.tiny_config(configs.make_cfg("se3eti2.3dmatch"))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dataset_root=str(tmp_path / "data" / "3DMatch"), point_limit=250))


def _trainer(cfg, outdir, max_epoch, **kw):
    from se3et_tpu_torch.engine.trainer import Trainer

    optim = dataclasses.replace(cfg.optim, max_epoch=max_epoch, lr=1e-3)
    trainer = Trainer(cfg.model, cfg.loss, cfg.eval, optim, str(outdir), seed=cfg.seed,
                      log_steps=2, device="cpu", **kw)
    trainer.initialize(None, steps_per_epoch=2)
    return trainer


def _weights(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tiny se3eti2 cut trained on two synthetic 250-point pairs and
    validated on two others: (a) two epochs straight; (b) one epoch, then a
    trainer resumed from its ``latest`` with the optimizer restored for the
    second; (c) a trainer loaded from (b)'s first ``latest`` by default."""
    from se3et_tpu_torch.experiments import runner

    tmp = tmp_path_factory.mktemp("trainer")
    cfg = _tiny(tmp)
    train = list(runner.pyramid_loader(runner.build_dataset(cfg, "train", True), cfg, limit=3))
    val = list(runner.pyramid_loader(runner.build_dataset(cfg, "val", False), cfg, limit=2))
    loaders = (lambda: iter(train[:2]), lambda: iter(val))
    straight = _trainer(cfg, tmp / "a", 2)
    straight.run(*loaders)
    first = _trainer(cfg, tmp / "b", 1)
    first.run(*loaders)
    default = _trainer(cfg, tmp / "b", 2)
    default.load_snapshot("latest")
    resumed = _trainer(cfg, tmp / "b", 2)
    resumed.load_snapshot("latest", restore_optimizer=True)
    resumed.run(*loaders)
    return {"cfg": cfg, "pairs": train, "tmp": tmp, "straight": straight, "first": first,
            "default": default, "resumed": resumed}


# the scalars each line carries (the JAX Trainer: the train step's losses
# with grad_norm and skipped; the val step's evaluate() metrics and losses)
TRAIN_KEYS = {"c_loss", "f_loss", "loss", "grad_norm", "skipped"}
VAL_KEYS = {"PIR", "IR", "RRE", "RTE", "RMSE", "RR", "c_loss", "f_loss", "loss"}


def test_trainer_run_writes_jax_format_events_and_snapshots(runs, tmp_path):
    """Two epochs of two steps (log every 2 steps): ``events.jsonl`` holds a
    ``train/`` and a ``val/`` line at iterations 2 and 4, each a JSON object
    of ``t``, ``step`` and the JAX trainer's scalars, laid out as the JAX
    ``MetricsWriter`` lays out the same values; the losses are finite and
    no step was skipped; the snapshots ``epoch-1``, ``epoch-2`` and
    ``latest`` exist."""
    from se3et_tpu.utils.metrics_writer import MetricsWriter as JaxWriter

    trainer = runs["straight"]
    assert (trainer.epoch, trainer.iteration) == (2, 4)
    with open(osp.join(trainer.output_dir, "events", "events.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    got = [({k.split("/")[0] for k in line if "/" in k}, line["step"]) for line in lines]
    assert got == [({"train"}, 2), ({"val"}, 2), ({"train"}, 4), ({"val"}, 4)]
    jw = JaxWriter(str(tmp_path / "jax_events"))
    for line in lines:
        prefix = "train/" if "train/loss" in line else "val/"
        keys = {k[len(prefix):] for k in line if k.startswith(prefix)}
        assert keys == (TRAIN_KEYS if prefix == "train/" else VAL_KEYS)
        assert set(line) == {"t", "step"} | {prefix + k for k in keys}
        assert all(np.isfinite(v) for v in line.values())
        jw.add_dict({k: line[prefix + k] for k in keys}, line["step"], prefix=prefix)
        if prefix == "train/":
            assert line["train/skipped"] == 0.0
    jw.close()
    with open(tmp_path / "jax_events" / "events.jsonl") as f:
        want = [json.loads(x) for x in f]
    assert [sorted(set(w) - {"t"}) for w in want] == [sorted(set(g) - {"t"}) for g in lines]
    assert [{k: v for k, v in w.items() if k != "t"} for w in want] == \
        [{k: v for k, v in g.items() if k != "t"} for g in lines]
    assert sorted(os.listdir(trainer.snapshot_dir)) == ["epoch-1", "epoch-2", "latest"]


def test_resume_with_the_optimizer_reproduces_the_run_bit_for_bit(runs):
    """One epoch, a snapshot, and a new trainer resumed from ``latest`` with
    ``restore_optimizer=True`` end the second epoch on the weights of the
    uninterrupted run bit for bit: the same epoch's generator draws the same
    targets, and AdamW's moments and the schedule come back as saved."""
    want, got = _weights(runs["straight"]), _weights(runs["resumed"])
    assert (runs["resumed"].epoch, runs["resumed"].iteration) == (2, 4)
    assert all(torch.equal(got[n], w) for n, w in want.items())
    first = _weights(runs["first"])
    assert not all(torch.equal(first[n], w) for n, w in want.items())


def test_default_resume_starts_a_fresh_optimizer_as_jax_does(runs, tmp_path):
    """``load_snapshot("latest")`` restores the weights, ``epoch`` and
    ``iteration`` and leaves the optimizer fresh (schedule at 0, no AdamW
    moments), as the JAX trainer's ``load_snapshot`` does: its orbax
    snapshot of the same weights with an advanced optimizer loads into a
    trainer whose ``opt_state`` stays ``tx.init``'s.  The next update from
    the same gradients is then the same on both sides (rtol 1e-5), on a
    dozen of the model's parameters spread over it (the others take no
    gradient, so AdamW leaves them)."""
    import orbax.checkpoint  # noqa: F401  (the JAX trainer's snapshots)
    from se3et_tpu.engine.trainer import OptimConfig as JaxOptim
    from se3et_tpu.engine.trainer import Trainer as JaxTrainer
    from se3et_tpu.engine.trainer import make_optimizer as jax_make_optimizer
    from se3et_tpu.experiments import make_cfg as jax_make_cfg

    default, first = runs["default"], runs["first"]
    assert (default.epoch, default.iteration) == (first.epoch, first.iteration) == (1, 2)
    saved = _weights(first)
    assert all(torch.equal(p, saved[n]) for n, p in _weights(default).items())
    assert default.optimizer.optimizer.state_dict()["state"] == {}
    assert default.optimizer.scheduler.last_epoch == 0
    assert first.optimizer.scheduler.last_epoch == 2

    jcfg = jax_make_cfg("se3eti2.3dmatch")
    optim = dataclasses.replace(jcfg.optim, **dataclasses.asdict(default.optim_cfg))
    names = sorted(saved)[::len(saved) // 12]
    jparams = {n.replace(".", "__"): saved[n].numpy() for n in names}
    rng = np.random.RandomState(14)
    grads = {k: np.asarray(rng.randn(*v.shape) * 1e-2, np.float32) for k, v in jparams.items()}
    jt = []
    for _ in range(2):
        t = JaxTrainer(jcfg.model, jcfg.loss, jcfg.eval, JaxOptim(**dataclasses.asdict(optim)),
                       str(tmp_path / "jax"), data_parallel=False)
        t.tx = jax_make_optimizer(t.optim_cfg, steps_per_epoch=2)
        jt.append(t)
    jt[0].params, jt[0].opt_state = jparams, jt[0].tx.init(jparams)
    for _ in range(2):  # an optimizer two updates in, as the port's first epoch left it
        upd, jt[0].opt_state = jt[0].tx.update(grads, jt[0].opt_state, jt[0].params)
    jt[0].epoch, jt[0].iteration = 1, 2
    jt[0].save_snapshot("latest")
    fresh = {k: np.zeros_like(v) for k, v in jparams.items()}
    jt[1].params, jt[1].opt_state = fresh, jt[1].tx.init(fresh)
    jt[1].load_snapshot("latest")
    assert (jt[1].epoch, jt[1].iteration) == (1, 2)
    counts = [[int(v) for _, v in optax.tree_utils.tree_get_all_with_path(t.opt_state, "count")]
              for t in jt]
    assert min(counts[0]) == 2 and set(counts[1]) == {0}
    upd, _ = jt[1].tx.update(grads, jt[1].opt_state, jt[1].params)
    want = optax.apply_updates(jt[1].params, upd)
    named = dict(default.model.named_parameters())
    for n in names:
        named[n].grad = torch.from_numpy(grads[n.replace(".", "__")].copy())
    default.optimizer.step()
    for n in names:
        np.testing.assert_allclose(named[n].detach().numpy(),
                                   np.asarray(want[n.replace(".", "__")]), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_trainer_pair_batching_pads_the_trailing_batch(runs):
    """``batch_size`` 2 over three pairs: one full batch and one padded at
    weight 0, two steps, finite losses, and the weights move."""
    cfg = runs["cfg"]
    trainer = _trainer(cfg, runs["tmp"] / "batched", 1, batch_size=2)
    assert trainer._batched_train_step is not None
    before = _weights(trainer)
    summary = trainer.train_epoch(iter(runs["pairs"]))
    assert trainer.iteration == 2
    assert all(np.isfinite(v) for v in summary.values())
    after = _weights(trainer)
    assert not all(torch.equal(after[n], w) for n, w in before.items())


def test_run_iterations_validates_and_snapshots_on_its_schedule(runs):
    """Iteration-based training over a two-pair loader, restarted when it
    ends: three iterations with validation and snapshots every two, then
    ``latest``; the weights move."""
    cfg = runs["cfg"]
    trainer = _trainer(cfg, runs["tmp"] / "iterations", 1)
    before = _weights(trainer)
    summary = trainer.run_iterations(runs["pairs"][:2], 3, lambda: iter(runs["pairs"][2:]),
                                     val_every=2, snapshot_every=2)
    assert trainer.iteration == 3 and np.isfinite(summary["loss"])
    assert sorted(os.listdir(trainer.snapshot_dir)) == ["iter-2", "latest"]
    with open(osp.join(trainer.output_dir, "events", "events.jsonl")) as f:
        steps = [(json.loads(x)["step"], "val/loss" in x) for x in f]
    assert steps == [(2, False), (2, True)]
    after = _weights(trainer)
    assert not all(torch.equal(after[n], w) for n, w in before.items())


def test_trainer_refuses_data_parallel_and_a_missing_card(tmp_path):
    """The data-parallel epoch is not ported (ROADMAP §A8); without a CUDA
    device the default device raises (no fallback to the CPU)."""
    from se3et_tpu_torch.engine.trainer import OptimConfig, Trainer

    cfg = _tiny(tmp_path)
    with pytest.raises(NotImplementedError, match="A8"):
        Trainer(cfg.model, cfg.loss, cfg.eval, OptimConfig(), str(tmp_path),
                data_parallel=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg.model, cfg.loss, cfg.eval, OptimConfig(), str(tmp_path))


# ----------------------------------------------------------------- runner
def test_trainval_then_test_from_the_snapshot(tmp_path, monkeypatch):
    """``trainval`` on the tiny se3eti2 cut with ``--device cpu`` (one epoch
    of one step, validation, snapshots), then ``test --snapshot
    <output>/snapshots/latest``, whose Tester serves the trained weights
    (finite metrics); ``--test_epoch 1`` resolves to the same snapshot; and
    ``main`` dispatches ``trainval --resume --max_epoch 2``, which loads
    ``latest`` and reaches epoch 2."""
    from se3et_tpu_torch.experiments import runner
    from tests.test_torch_tester import _tiny_experiment

    cfg, outdir = _tiny_experiment(tmp_path, monkeypatch, name="se3eti2.3dmatch")
    argv = ["--max_epoch", "1", "--max_steps_per_epoch", "1", "--no_calibrate",
            "--device", "cpu"]
    trainer = runner.run_trainval(cfg, argv)
    assert (trainer.epoch, trainer.iteration) == (1, 1)
    snap = osp.join(outdir, "snapshots", "latest")
    assert sorted(os.listdir(osp.join(outdir, "snapshots"))) == ["epoch-1", "latest"]
    trained = trainer.model.state_dict()
    for args in (["--snapshot", snap], ["--test_epoch", "1"]):
        tester, loader, benchmark = runner.prepare_test(
            cfg, args + ["--max_pairs", "1", "--no_calibrate", "--device", "cpu"])
        assert all(torch.equal(v, trained[k]) for k, v in tester.model.state_dict().items())
        summary = tester.run(loader, benchmark=benchmark)
        assert all(np.isfinite(v) for v in summary.values())
    monkeypatch.setattr(runner, "make_cfg", lambda name: cfg)
    resumed = runner.main([cfg.name, "trainval", "--max_epoch", "2", "--resume"] + argv[2:])
    assert (resumed.epoch, resumed.iteration) == (2, 2)
    assert sorted(os.listdir(osp.join(outdir, "snapshots"))) == ["epoch-1", "epoch-2",
                                                                  "latest"]
