"""The PyTorch port's training step against the JAX ``make_train_step``, on
the CPU.

One tiny pair of SE3ET-E (``tiny_flash_config``: 128-point coarse stage,
600 input points, float32 training), and of the wide-head family's
se3ete2 and se3eti2 at their head width 32 (transformer width 128,
``init_dim`` 32: K5 and K11 at 32), goes through both packages with the
training routes on (``train_fused_conv``, ``train_fused_embedding``,
``train_fused_attention``): the exact gather route with the K8/K9
backwards' plain versions against JAX's gather gradients, K3 + K10 plain
against ``geometric_embedding_trainable`` (Pallas interpret), K5 + K11
plain against ``rpe_self_attention_trainable`` (interpret), materialised
EQ cross layers, K4 + the scan-form backward on both sides.  Weights are
numpy draws converted with ``se3et_tpu_torch.convert``; the JAX gradient
tree converts with the same ``flax_to_state_dict``, so gradients compare by
parameter name.  Torch cannot reproduce ``jax.random.gumbel``: both sides
get one fixed numpy Gumbel array for the target sampling (on the JAX side
by patching ``jax.random.gumbel`` inside the test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)


def _random_params(shapes, seed=0):
    """numpy parameters for a flax shape tree: U(+-1/sqrt(fan_in)) for
    matrices, norm scales 1 +- 0.1, biases +- 0.1, Sinkhorn alpha 1."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "alpha":
            return np.ones(s.shape, np.float32)
        if len(s.shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.uniform(-0.1, 0.1, s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _grab_grads():
    """An optax transformation that applies no update and keeps the
    gradients it was given as its state (to read them out of the JAX
    ``make_train_step``)."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module", params=["se3ete", "se3ete2", "se3eti2"])
def step_pair(request):
    import __graft_entry__ as ge
    from se3et_tpu.engine.steps import make_train_step as jax_train_step
    from se3et_tpu.nn import loss as jloss
    from se3et_tpu.nn import matching as jmatching
    from se3et_tpu.ops import geometry as jgeometry
    from se3et_tpu.nn.model import SE3ETModel as JaxModel
    from se3et_tpu_torch.convert import flax_to_state_dict, load_flax_params
    from se3et_tpu_torch.engine.steps import make_train_step
    from se3et_tpu_torch.engine.trainer import OptimConfig, make_optimizer
    from se3et_tpu_torch.nn import matching
    from se3et_tpu_torch.nn.epn import EPNConfig
    from se3et_tpu_torch.nn.loss import LossConfig
    from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors

    if request.param == "se3ete":
        _, pipeline, jcfg = ge._flagship_configs(tiny=True)
        pipeline = dataclasses.replace(pipeline, patch_k=jcfg.num_points_in_patch,
                                       stage_caps=(256, 192, 160, 128), coarse_point_cap=128)
    else:  # the wide-head family's tiny flash cut (tests/test_torch_wide_head.py)
        from tests.test_torch_wide_head import _jax_tiny

        jcfg, pipeline = _jax_tiny(f"{request.param}.3dmatch", flash=True)
        assert jcfg.gt_hidden_dim // jcfg.num_heads == 32
    jcfg = dataclasses.replace(jcfg, serve_fused_attention=True, train_fused_conv=True,
                               train_fused_embedding=True, train_fused_attention=True)
    data = ge._example_pair(pipeline, num_points=600, seed=0, model_cfg=jcfg)
    data = {k: (np.asarray(v, np.float32)
                if k.startswith("influence_") and k != "influence_sig" else v)
            for k, v in data.items()}
    n_coarse = data["points_3"].shape[1]
    noise = np.random.RandomState(11).gumbel(size=(n_coarse, n_coarse)).astype(np.float32)

    jmodel = JaxModel(jcfg)
    rngs = {"params": jax.random.PRNGKey(0), "targets": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda d: jmodel.init(rngs, d, train=True,
                                                  with_registration=False), data)
    params = _random_params(shapes)
    jloss_cfg = jloss.LossConfig()
    jstep = jax_train_step(jmodel, jloss_cfg, _grab_grads())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32:
                   jnp.asarray(noise, dtype))
        _, jgrads, jlosses = jax.jit(jstep)(params, _grab_grads().init(params), data,
                                            jax.random.PRNGKey(1))
        # the JAX model's ground-truth overlaps (its train=True forward calls
        # node_correspondences on the host partition's patches), without
        # compiling the whole forward again
        jout = {"gt_overlap_mat": jax.jit(lambda d: jmatching.node_correspondences(
            d["points_3"][0], d["points_3"][1],
            *jax.vmap(jgeometry.gather_with_sentinel)(d["points_1"], d["node_knn_indices"]),
            d["transform"], jcfg.ground_truth_matching_radius, *d["patch_node_masks"],
            *d["node_knn_masks"], num_candidates=jcfg.gt_candidates))(data)}
        jtargets = jmatching.superpoint_targets(
            rngs["targets"], jout["gt_overlap_mat"], jcfg.num_targets, jcfg.overlap_threshold)

    fields = dataclasses.asdict(jcfg)
    fields["epn"] = EPNConfig(**fields["epn"])
    port = load_flax_params(SE3ETModel(ModelConfig(**fields), device="cpu"), params)
    tdata = pyramid_to_tensors(data, "cpu")
    tnoise = torch.from_numpy(noise)
    with torch.no_grad():
        out = port(tdata, train=True, with_registration=False, target_noise=tnoise)
    targets = matching.superpoint_targets(out["gt_overlap_mat"], jcfg.num_targets,
                                          jcfg.overlap_threshold, noise=tnoise)
    step = make_train_step(port, LossConfig(), make_optimizer(port.parameters(),
                                                              OptimConfig(), 10))
    losses = step(tdata, target_noise=tnoise)
    return {
        "jax": {"out": jax.tree.map(np.asarray, jout), "losses": jax.tree.map(float, jlosses),
                "grads": flax_to_state_dict(jax.tree.map(np.array, jgrads)),
                "targets": [np.asarray(t) for t in jtargets]},
        "port": {"out": out, "losses": {k: float(v) for k, v in losses.items()},
                 "grads": {n: p.grad.clone() for n, p in port.named_parameters()},
                 "targets": targets},
    }


def test_gt_overlap_matrix_matches_jax(step_pair):
    """node_correspondences: the (M, N) overlap matrix, float32 geometry on
    both sides; to 1e-6, and not empty."""
    want = step_pair["jax"]["out"]["gt_overlap_mat"]
    got = step_pair["port"]["out"]["gt_overlap_mat"].numpy()
    assert (want > 0.1).sum() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _pairs(ref, src, valid):
    return {(int(r), int(s)) for r, s, v in zip(ref, src, valid) if v}


def test_superpoint_targets_match_as_sets(step_pair):
    """With the same Gumbel noise the valid sampled targets are the same
    set of (ref, src) node pairs."""
    got = _pairs(*(np.asarray(t) for t in step_pair["port"]["targets"][:2]),
                 np.asarray(step_pair["port"]["targets"][3]))
    jt = step_pair["jax"]["targets"]
    want = _pairs(jt[0], jt[1], jt[3])
    assert len(want) > 0
    assert got == want


@pytest.mark.parametrize("name", ["c_loss", "f_loss", "loss"])
def test_losses_match_jax(step_pair, name):
    """Coarse, fine and total loss of one step; rtol 1e-3 (the embedding
    is bf16 on both sides, rounded after float32 projections in the port
    and after bf16 products in the JAX kernel)."""
    got, want = step_pair["port"]["losses"][name], step_pair["jax"]["losses"][name]
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_grad_norm_matches_jax(step_pair):
    """The global gradient norm make_train_step returns; rtol 1e-3."""
    np.testing.assert_allclose(step_pair["port"]["losses"]["grad_norm"],
                               step_pair["jax"]["losses"]["grad_norm"], rtol=1e-3)


def test_every_parameter_gradient_matches_jax(step_pair):
    """Every parameter's gradient, by name: |g - g_jax| <= 5e-2 |g_jax| +
    5e-5 per tensor (Frobenius norms), and 1e-2 over all parameters
    together.  The embedding is bf16 on both sides but rounded after
    float32 projections in the port and after bf16 products in the JAX
    kernel, whose backward also takes bf16 products; the ~1 ulp
    differences move ReLU and max kinks downstream, which shows most in the
    feed-forward layers after the self layers.  The absolute term covers
    gradients that are zero up to rounding (key biases under the softmax,
    biases before a group norm)."""
    want, got = step_pair["jax"]["grads"], step_pair["port"]["grads"]
    assert set(got) == set(want)
    bad, err2, ref2 = [], 0.0, 0.0
    for name, w in want.items():
        err = float(torch.linalg.norm(got[name] - w))
        ref = float(torch.linalg.norm(w))
        err2, ref2 = err2 + err**2, ref2 + ref**2
        if not err <= 5e-2 * ref + 5e-5:
            bad.append((name, err, ref))
    assert not bad, bad
    assert err2**0.5 <= 1e-2 * ref2**0.5


def test_adamw_update_matches_optax():
    """make_optimizer's AdamW + stepped schedule (+ clipping) against the
    JAX make_optimizer (optax.adamw) over 3 steps crossing an epoch
    boundary (steps_per_epoch 2); float32, rtol 1e-5."""
    from se3et_tpu.engine.trainer import OptimConfig as JaxOptim
    from se3et_tpu.engine.trainer import make_optimizer as jax_make_optimizer
    from se3et_tpu_torch.engine.trainer import OptimConfig, make_optimizer

    rng = np.random.RandomState(8)
    shapes = {"w": (5, 3), "b": (3,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    for clip in (None, 1.0):
        fields = dict(lr=1e-2, lr_decay=0.5, lr_decay_steps=1, weight_decay=0.1,
                      max_grad_norm=clip)
        tx = jax_make_optimizer(JaxOptim(**fields), steps_per_epoch=2)
        jp, state = dict(p0), tx.init(p0)
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
        opt = make_optimizer(tp.values(), OptimConfig(**fields), steps_per_epoch=2)
        for g in grads:
            upd, state = tx.update(g, state, jp)
            jp = optax.apply_updates(jp, upd)
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()
            for k in shapes:
                np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                           rtol=1e-5, atol=1e-7)


def test_non_finite_gradient_skips_the_update():
    """A step whose gradient norm is not finite (loss scaled by inf) leaves
    the parameters, the AdamW state and the schedule as they were."""
    from se3et_tpu_torch.engine.steps import make_train_step
    from se3et_tpu_torch.engine.trainer import OptimConfig, make_optimizer
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, tiny_flash_config
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.nn.loss import LossConfig
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    cfg = tiny_flash_config(serving_config(make_cfg("se3ete.3dmatch")))
    data = pyramid_to_tensors(synthetic_pair(0, cfg.pipeline, cfg.model, 250, 2.0), "cpu")
    model = SE3ETModel(cfg.model, seed=3, device="cpu")
    opt = make_optimizer(model.parameters(), OptimConfig(), 10)
    gen = torch.Generator().manual_seed(0)
    ok = make_train_step(model, LossConfig(), opt)(data, generator=gen)
    assert bool(torch.isfinite(ok["grad_norm"]))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = {k: {n: t.clone() for n, t in v.items() if torch.is_tensor(t)}
             for k, v in opt.optimizer.state.items()}
    last = (opt.scheduler.last_epoch, [g["lr"] for g in opt.optimizer.param_groups])
    bad = make_train_step(model, LossConfig(), opt, loss_scale=float("inf"))(
        data, generator=gen)
    assert not bool(torch.isfinite(bad["grad_norm"]))
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    for k, v in opt.optimizer.state.items():
        for n, t in state[k].items():
            assert torch.equal(v[n], t)
    assert (opt.scheduler.last_epoch, [g["lr"] for g in opt.optimizer.param_groups]) == last
