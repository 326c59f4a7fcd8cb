"""The PyTorch port's serving forward against the JAX model, on the CPU.

One tiny SE3ET-E pair (``__graft_entry__._flagship_configs(tiny=True)``)
goes through both packages in float32 with exact math on both sides:
neighbours indexed directly (``window_segments=0``), materialised
attention (``serve_fused_attention=False``) and the XLA embedding route
(``serve_fused_embedding=False``).  Weights are drawn with numpy from a
seed into the flax tree and converted with ``se3et_tpu_torch.convert``.
The port is cut at each ``stop_after`` point and compared, on valid rows,
with the JAX forward.
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


@pytest.fixture(scope="module")
def pair():
    import __graft_entry__ as ge
    from se3et_tpu.nn.model import SE3ETModel as JaxModel
    from se3et_tpu_torch.convert import load_flax_params
    from se3et_tpu_torch.nn.epn import EPNConfig
    from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors

    _, pipeline, jcfg = ge._flagship_configs(tiny=True)
    # host point-to-node partition, as the production pipeline ships it
    pipeline = dataclasses.replace(pipeline, patch_k=jcfg.num_points_in_patch)
    jcfg = dataclasses.replace(jcfg, serve_fused_embedding=False)
    data = ge._example_pair(pipeline, num_points=250, seed=0, model_cfg=jcfg)
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
    port = SE3ETModel(ModelConfig(**fields))
    load_flax_params(port, params)
    tdata = pyramid_to_tensors(data, "cpu")
    return {
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
    """Normalised coarse features after the transformer, rtol 1e-4."""
    mc = pair["data"]["masks_3"]
    got = pair["port"]["transformer"]
    for i, key in enumerate(("ref_feats_c", "src_feats_c")):
        _close(got[key][torch.from_numpy(mc[i])], pair["jax"][key][mc[i]], 1e-4)


def _pairs(out):
    ref = np.asarray(out["ref_node_corr_indices"])
    src = np.asarray(out["src_node_corr_indices"])
    valid = np.asarray(out["node_corr_valid"])
    return [(int(r), int(s)) for r, s, v in zip(ref, src, valid) if v]


def test_superpoint_correspondences_match_as_sets(pair):
    """The valid coarse correspondences are the same set (slot order and
    exact ties may differ between torch.topk and global_topk)."""
    got, want = _pairs(pair["port"]["matching"]), _pairs(pair["jax"])
    assert len(got) == len(set(got)) > 0
    assert set(got) == set(want)


def test_matching_scores_match_jax(pair):
    """Sinkhorn log-probabilities per correspondence (rows aligned by the
    (ref, src) node pair), on valid entries incl. the dustbins, to 1e-3."""
    got, want = pair["port"]["sinkhorn"], pair["jax"]
    row_of = {p: i for i, p in enumerate(_pairs(got))}
    for j, p in enumerate(_pairs(want)):
        i = row_of[p]
        rv = np.append(np.asarray(want["ref_node_corr_knn_masks"][j]), True)
        cv = np.append(np.asarray(want["src_node_corr_knn_masks"][j]), True)
        np.testing.assert_array_equal(got["ref_node_corr_knn_masks"][i].numpy(), rv[:-1])
        valid = rv[:, None] & cv[None, :]
        np.testing.assert_allclose(got["matching_scores"][i].numpy()[valid],
                                   want["matching_scores"][j][valid], rtol=1e-3, atol=1e-3)


def test_estimated_transform_matches_jax(pair):
    got = pair["port"][""]["estimated_transform"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pair["jax"]["estimated_transform"], rtol=1e-3,
                               atol=1e-3)


def test_port_config_matches_jax_registry():
    """The port's se3ete.3dmatch values equal make_cfg's, field for field."""
    from se3et_tpu.experiments import make_cfg as jax_make_cfg
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config

    want, got = jax_make_cfg("se3ete.3dmatch"), make_cfg("se3ete.3dmatch")
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert got.pipeline == want.pipeline
    assert (got.name, got.seed, got.dataset, got.point_limit) == (
        want.name, want.seed, want.data.dataset, want.data.point_limit)
    served = serving_config(got)
    assert served.pipeline.window_segments == 0
    assert not served.model.serve_fused_attention
    assert served.model.serve_fused_embedding and served.model.serve_fused_sinkhorn


def test_port_tiny_config_matches_graft_entry():
    """The port's tiny cut equals __graft_entry__'s tiny flagship config
    (with the host point-to-node partition switched on)."""
    import __graft_entry__ as ge
    from se3et_tpu_torch.experiments.configs import make_cfg, tiny_config

    _, pipeline, model = ge._flagship_configs(tiny=True)
    got = tiny_config(make_cfg("se3ete.3dmatch"))
    assert got.pipeline == dataclasses.replace(pipeline, patch_k=model.num_points_in_patch)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(model)


_BLOCKED = ("jax", "flax", "optax", "ml_dtypes")
# the JAX package's numpy-only modules, which the port shares
_SHARED = (
    "se3et_tpu.core.anchors", "se3et_tpu.core.kernel_points",
    "se3et_tpu.core.harmonics", "se3et_tpu.data.pipeline",
    "se3et_tpu.data.host_ops", "se3et_tpu.data.native_bridge",
    "se3et_tpu.data.datasets",
)


def _import_allowed(name: str) -> bool:
    if name.split(".")[0] in _BLOCKED:
        return False
    if name == "se3et_tpu" or name.startswith("se3et_tpu."):
        return any(name == s or name.startswith(s + ".") for s in _SHARED)
    return True


def test_port_source_has_no_jax_imports():
    """No module of the port imports JAX, flax, optax or ml_dtypes, or a
    module of the JAX package other than the shared numpy-only ones —
    lazy imports inside functions included."""
    offenders = []
    pkg = REPO / "se3et_tpu_torch"
    for path in pkg.rglob("*.py"):
        if "_build" in path.relative_to(pkg).parts:  # kernel build outputs
            continue
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
out = SE3ETModel(cfg.model)(pyramid_to_tensors(data, "cpu"))
assert torch.isfinite(out["estimated_transform"]).all()
assert not any(sys.modules.get(n) for n in {blocked!r})
print("ok")
"""


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
