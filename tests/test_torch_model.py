"""The PyTorch port's serving forward against the JAX model, on the CPU.

One tiny SE3ET-E pair goes through both packages in float32 with exact
math on both sides: neighbours indexed directly (``window_segments=0``)
and the XLA embedding route (``serve_fused_embedding=False``), on four
routes, and the SE3ET-I block layout (``se3eti.3dmatch``: ``self_eq,
cross`` three times with no equivariant levels, so its self_eq layers carry
no SH term) on the first two (``materialised-I``, ``flash-I``):

* ``materialised``: ``__graft_entry__._flagship_configs(tiny=True)``
  (24-point coarse stage, ``serve_fused_attention=False``);
* ``flash``: the port's ``tiny_flash_config`` (128-point coarse stage, 600
  input points, ``serve_fused_attention=True``), where the self layers take
  K5 and the EQ cross layers K6 + K7 (their plain versions on the CPU; the
  Pallas kernels in interpret mode on the JAX side);
* ``flash_femb``: ``flash`` with ``serve_femb=True`` on both sides: the self
  layers take K16 (JAX: ``rpe_self_attention_femb`` in interpret mode),
  and no embedding is computed;
* ``device_influence``: ``materialised`` on a pyramid built without host
  influence: the port computes it with K15 (its plain version), JAX with
  ``_influence_weights`` (no window maps at ``window_segments=0``).

Weights are drawn with numpy from a seed into the flax tree and converted
with ``se3et_tpu_torch.convert``.  The port is cut at each ``stop_after``
point and compared, on valid rows, with the JAX forward.  The port serves
with ``serve_fused_conv=True`` (K12/K13's plain versions), the JAX side on
its exact route (no window maps): the same function in float32.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


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


# JAX's femb route runs its self layers in bf16 (its kernel rounds the
# Chebyshev bases, the folded projections and the angle max to bf16 and the
# layer casts q, k, v to bf16), where the port's float32 route rounds
# nothing: the features after the transformer are held at 3e-3 of their
# scale, JAX's own femb-vs-materialised tolerance (measured: 4.0e-4
# absolute on unit-norm features); every other route and cut at the
# float32 tolerances below
_TRANSFORMER_RTOL = {"flash_femb": 3e-3}


def _se3eti(jcfg):
    """``jcfg`` with the SE3ET-I transformer of JAX's ``se3eti.3dmatch``."""
    from se3et_tpu.experiments import make_cfg as jax_make_cfg

    i = jax_make_cfg("se3eti.3dmatch").model
    return dataclasses.replace(
        jcfg, blocks=i.blocks, n_level_equiv=i.n_level_equiv,
        attn_r_positive=i.attn_r_positive,
        attn_r_positive_rot_supervise=i.attn_r_positive_rot_supervise)


@pytest.fixture(scope="module", params=["materialised", "flash", "flash_femb",
                                        "device_influence", "materialised-I", "flash-I"])
def pair(request):
    import __graft_entry__ as ge
    from se3et_tpu.nn.model import SE3ETModel as JaxModel
    from se3et_tpu_torch.convert import load_flax_params
    from se3et_tpu_torch.nn.epn import EPNConfig
    from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors

    _, pipeline, jcfg = ge._flagship_configs(tiny=True)
    # host point-to-node partition, as the production pipeline ships it
    pipeline = dataclasses.replace(pipeline, patch_k=jcfg.num_points_in_patch)
    jcfg = dataclasses.replace(jcfg, serve_fused_embedding=False)
    if request.param.endswith("-I"):
        jcfg = _se3eti(jcfg)
    num_points = 250
    if request.param.startswith("flash"):
        pipeline = dataclasses.replace(pipeline, stage_caps=(256, 192, 160, 128),
                                       coarse_point_cap=128)
        jcfg = dataclasses.replace(jcfg, serve_fused_attention=True,
                                   serve_femb=request.param == "flash_femb")
        num_points = 600
    host_influence = request.param != "device_influence"
    data = ge._example_pair(pipeline, num_points=num_points, seed=0,
                            model_cfg=jcfg if host_influence else None)
    assert host_influence == ("influence_same_0" in data)
    # host influence arrives as ml_dtypes.bfloat16; both sides get the same
    # float32 values
    data = {k: (np.asarray(v, np.float32)
                if k.startswith("influence_") and k != "influence_sig" else v)
            for k, v in data.items()}

    jmodel = JaxModel(jcfg)
    rngs = {"params": jax.random.PRNGKey(0), "targets": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda d: jmodel.init(rngs, d, train=False, with_gt=False,
                                                  with_registration=False), data)
    params = _random_params(shapes)

    def run(stop_after):
        fn = jax.jit(lambda p, d: jmodel.apply(p, d, train=False, with_gt=False,
                                               stop_after=stop_after))
        return jax.tree.map(np.asarray, fn(params, data))

    fields = dataclasses.asdict(jcfg)
    fields["epn"] = EPNConfig(**fields["epn"])
    port = SE3ETModel(ModelConfig(**fields), device="cpu")
    load_flax_params(port, params)
    tdata = pyramid_to_tensors(data, "cpu")
    return {
        "route": request.param,
        "cfg": jcfg,
        "data": data,
        "jax": run(""),
        "jax_backbone": run("backbone"),
        "port": {cut: port(tdata, stop_after=cut)
                 for cut in ("backbone", "transformer", "matching", "sinkhorn", "")},
    }


def _close(got, want, rtol):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_backbone_matches_jax(pair):
    """feats_f / feats_c on valid points, rtol 1e-4 of the output scale."""
    m1, mc = pair["data"]["masks_1"], pair["data"]["masks_3"]
    want, got = pair["jax_backbone"], pair["port"]["backbone"]
    _close(got["feats_f"][torch.from_numpy(m1)], want["feats_f"][m1], 1e-4)
    _close(got["feats_c"][torch.from_numpy(mc)], want["feats_c"][mc], 1e-4)


def test_transformer_matches_jax(pair):
    """Normalised coarse features after the transformer, rtol 1e-4 (the
    femb route: see _TRANSFORMER_RTOL)."""
    mc = pair["data"]["masks_3"]
    got = pair["port"]["transformer"]
    rtol = _TRANSFORMER_RTOL.get(pair["route"], 1e-4)
    for i, key in enumerate(("ref_feats_c", "src_feats_c")):
        _close(got[key][torch.from_numpy(mc[i])], pair["jax"][key][mc[i]], rtol)


def _pairs(out):
    ref = np.asarray(out["ref_node_corr_indices"])
    src = np.asarray(out["src_node_corr_indices"])
    valid = np.asarray(out["node_corr_valid"])
    return [(int(r), int(s)) for r, s, v in zip(ref, src, valid) if v]


def _assert_same_correspondences(got, want):
    got, want = _pairs(got), _pairs(want)
    assert len(got) == len(set(got)) > 0
    assert set(got) == set(want)


def test_superpoint_correspondences_match_as_sets(pair):
    """The valid coarse correspondences are the same set (slot order and
    exact ties may differ between torch.topk and global_topk)."""
    _assert_same_correspondences(pair["port"]["matching"], pair["jax"])


def _assert_scores_close(got, want):
    row_of = {p: i for i, p in enumerate(_pairs(got))}
    for j, p in enumerate(_pairs(want)):
        i = row_of[p]
        rv = np.append(np.asarray(want["ref_node_corr_knn_masks"][j]), True)
        cv = np.append(np.asarray(want["src_node_corr_knn_masks"][j]), True)
        np.testing.assert_array_equal(got["ref_node_corr_knn_masks"][i].numpy(), rv[:-1])
        valid = rv[:, None] & cv[None, :]
        np.testing.assert_allclose(got["matching_scores"][i].numpy()[valid],
                                   want["matching_scores"][j][valid], rtol=1e-3, atol=1e-3)


def test_matching_scores_match_jax(pair):
    """Sinkhorn log-probabilities per correspondence (rows aligned by the
    (ref, src) node pair), on valid entries incl. the dustbins, to 1e-3."""
    _assert_scores_close(pair["port"]["sinkhorn"], pair["jax"])


_LGR_INPUTS = ("ref_node_corr_knn_points", "src_node_corr_knn_points",
               "ref_node_corr_knn_masks", "src_node_corr_knn_masks", "matching_scores")


def _lgr_settings(cfg):
    return dict(k=cfg.fine_topk, acceptance_radius=cfg.acceptance_radius, mutual=cfg.mutual,
                confidence_threshold=cfg.confidence_threshold, use_dustbin=cfg.use_dustbin,
                correspondence_threshold=cfg.correspondence_threshold,
                correspondence_limit=cfg.correspondence_limit,
                num_refinement_steps=cfg.num_refinement_steps)


def _port_lgr_on_jax_inputs(pair):
    from se3et_tpu_torch.nn.matching import local_global_registration

    args = [torch.tensor(np.asarray(pair["jax"][k])) for k in _LGR_INPUTS]
    return local_global_registration(*args, **_lgr_settings(pair["cfg"]))


def test_registration_matches_jax_on_same_inputs(pair):
    """The patch points, masks and matching scores that JAX's registration
    consumed (its Sinkhorn-stage outputs) go to both packages'
    local_global_registration with the model's settings: the transform and
    the correspondence scores (in descending order) agree within 1e-4."""
    import jax.numpy as jnp
    from se3et_tpu.nn.matching import local_global_registration

    settings = _lgr_settings(pair["cfg"])
    args = [jnp.asarray(pair["jax"][k]) for k in _LGR_INPUTS]
    want = jax.tree.map(np.asarray, jax.jit(
        lambda *a: local_global_registration(*a, **settings))(*args))
    got = _port_lgr_on_jax_inputs(pair)
    np.testing.assert_allclose(got["estimated_transform"].numpy(),
                               want["estimated_transform"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.sort(got["corr_scores"].numpy())[::-1],
                               np.sort(want["corr_scores"])[::-1], rtol=1e-4, atol=1e-4)


def test_estimated_transform_matches_jax(pair):
    """The port's transform against JAX's, from scores that differ by
    rounding.  The registration is discontinuous in its scores (top-k
    correspondence picks, the best-hypothesis argmax, the ``res <
    acceptance_radius`` inlier masks), so a score difference well inside
    the 1e-3 held above can flip a choice or, with fewer than three
    inliers, move an undetermined fit; a continuous tolerance alone cannot
    hold it.  So: the coarse correspondences are the same set and the
    matching scores agree within 1e-3; JAX's decisions are those of the
    port's registration on JAX's own inputs (which equals JAX's, held by
    ``test_registration_matches_jax_on_same_inputs``); where both sides make
    the same decisions and their inliers determine the fit, the transforms
    agree within 1e-3, else the port's transform is a finite proper rigid
    transform that aligns JAX's final inliers within the acceptance radius
    (``selfcheck.registration_agreement``)."""
    from se3et_tpu_torch.ops.kernels import selfcheck

    got = pair["port"][""]
    _assert_same_correspondences(got, pair["jax"])
    _assert_scores_close(got, pair["jax"])
    want = dict(_port_lgr_on_jax_inputs(pair),
                estimated_transform=torch.from_numpy(pair["jax"]["estimated_transform"]))
    ok, text = selfcheck.registration_agreement(got, want, pair["cfg"].acceptance_radius)
    assert ok, text


PORTED_EXPERIMENTS = ("se3ete.3dmatch", "se3ete.3dmatch.evalrot", "se3eti.3dmatch",
                      "se3eti.3dmatch.evalrot", "se3ete2.3dmatch", "se3ete2.3dmatch.evalrot",
                      "se3eti2.3dmatch", "se3eti2.3dmatch.evalrot",
                      "se3eti2.3dmatch.evalkitti")


@pytest.mark.parametrize("name", PORTED_EXPERIMENTS)
def test_port_config_matches_jax_registry(name):
    """The port's registry entry equals JAX's ``make_cfg(name)`` field for
    field (model, pipeline, loss, optimizer, data, eval, name and seed), and
    its serving cut indexes neighbours directly and keeps the JAX routes."""
    from se3et_tpu.experiments import make_cfg as jax_make_cfg
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config

    want, got = jax_make_cfg(name), make_cfg(name)
    for part in ("model", "pipeline", "loss", "optim", "data", "eval"):
        assert dataclasses.asdict(getattr(got, part)) == dataclasses.asdict(
            getattr(want, part)), part
    assert (got.name, got.seed) == (want.name, want.seed)
    assert got.output_dir == os.path.join(str(REPO), "output", "torch", name)
    served = serving_config(got)
    assert served.pipeline.window_segments == 0
    assert served.model.serve_fused_attention  # the JAX default: flash kernels
    assert not served.model.serve_femb
    assert served.model.serve_fused_embedding and served.model.serve_fused_sinkhorn
    # the same cut trains on the JAX training routes: the backward kernels, float32
    assert served.model.train_fused_conv and served.model.train_fused_embedding
    assert served.model.train_fused_attention and not served.model.bf16_train


def test_port_registry_holds_the_ported_entries_only():
    """Every other name of the JAX registry raises ``KeyError`` in the port."""
    from se3et_tpu.experiments.configs import EXPERIMENTS as JAX_EXPERIMENTS
    from se3et_tpu_torch.experiments.configs import EXPERIMENTS, make_cfg

    assert set(EXPERIMENTS) == set(PORTED_EXPERIMENTS) < set(JAX_EXPERIMENTS)
    for name in sorted(set(JAX_EXPERIMENTS) - set(PORTED_EXPERIMENTS)) + ["no.such"]:
        with pytest.raises(KeyError):
            make_cfg(name)


@pytest.mark.parametrize("flash", [False, True])
def test_port_tiny_config_matches_graft_entry(flash):
    """The port's tiny cut equals __graft_entry__'s tiny flagship config
    (with the host point-to-node partition switched on); its flash variant
    has a 128-point coarse stage and the flash attention route on."""
    import __graft_entry__ as ge
    from se3et_tpu_torch.experiments.configs import make_cfg, tiny_config, tiny_flash_config

    _, pipeline, model = ge._flagship_configs(tiny=True)
    pipeline = dataclasses.replace(pipeline, patch_k=model.num_points_in_patch)
    if flash:
        pipeline = dataclasses.replace(pipeline, stage_caps=(256, 192, 160, 128),
                                       coarse_point_cap=128)
        model = dataclasses.replace(model, serve_fused_attention=True)
    got = (tiny_flash_config if flash else tiny_config)(make_cfg("se3ete.3dmatch"))
    assert dataclasses.asdict(got.pipeline) == dataclasses.asdict(pipeline)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(model)


_BLOCKED = ("jax", "flax", "optax", "ml_dtypes", "se3et_tpu")
# modules of the JAX package the port may import: none (it keeps copies of
# the numpy-only ones, held equal by tests/test_torch_shared_copies.py)
_SHARED = ()


def _import_allowed(name: str) -> bool:
    if name.split(".")[0] in _BLOCKED:
        return False
    if name == "se3et_tpu" or name.startswith("se3et_tpu."):
        return any(name == s or name.startswith(s + ".") for s in _SHARED)
    return True


def test_port_source_has_no_jax_imports():
    """No module of the port, and not chip_smoke.py, imports JAX, flax,
    optax, ml_dtypes or any module of the JAX package -- lazy imports
    inside functions included."""
    offenders = []
    pkg = REPO / "se3et_tpu_torch"
    paths = [p for p in pkg.rglob("*.py")
             if "_build" not in p.relative_to(pkg).parts]  # kernel build outputs
    for path in paths + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}: {n}" for n in names
                          if not _import_allowed(n)]
    assert not offenders, offenders


_NO_JAX_SCRIPT = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import importlib, pkgutil
import se3et_tpu_torch
for mod in pkgutil.walk_packages(se3et_tpu_torch.__path__, "se3et_tpu_torch."):
    importlib.import_module(mod.name)
import torch
torch.set_num_threads(1)
from se3et_tpu_torch.data.pyramid import synthetic_pair
from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, tiny_config
from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors
cfg = tiny_config(serving_config(make_cfg("se3ete.3dmatch")))
data = synthetic_pair(0, cfg.pipeline, cfg.model, num_points=250, extent=2.0)
out = SE3ETModel(cfg.model, device="cpu")(pyramid_to_tensors(data, "cpu"))
assert torch.isfinite(out["estimated_transform"]).all()
assert not any(sys.modules.get(n) for n in {blocked!r})
print("ok")
"""


def test_model_without_device_needs_cuda():
    """SE3ETModel runs on the card unless the caller asks for the CPU: with
    no CUDA device, constructing it without ``device`` raises."""
    from se3et_tpu_torch.experiments.configs import make_cfg, tiny_config
    from se3et_tpu_torch.nn.model import SE3ETModel

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SE3ETModel(tiny_config(make_cfg("se3ete.3dmatch")).model)


def test_port_runs_with_jax_blocked():
    """In a process where JAX & co. cannot be imported, every module of the
    port imports and a tiny CPU forward runs."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT.format(blocked=_BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
