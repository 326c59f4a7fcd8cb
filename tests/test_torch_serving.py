"""The port's serving engine on the CPU: ``make_forward`` against the model
call and against the JAX package's ``make_forward`` on the same weights,
the refusals of ``capture_forward`` and of its input check, and the
capture-safe ``gather_with_sentinel``.  The captured graph itself runs only
on the card (``tests/test_torch_serving_cuda.py``)."""

import dataclasses
import traceback

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_model import (
    _assert_same_correspondences, _assert_scores_close, _close, _port_lgr_on_jax_inputs,
    _random_params,
)

torch.set_num_threads(1)


def _tiny(bare=False):
    """The tiny materialised cut, its CPU model and one pair (with host
    influence unless ``bare``)."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, tiny_config
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    cfg = tiny_config(serving_config(make_cfg("se3ete.3dmatch")))
    pair = synthetic_pair(0, cfg.pipeline, None if bare else cfg.model, 250, 2.0)
    return cfg, SE3ETModel(cfg.model, device="cpu"), pyramid_to_tensors(pair, "cpu")


def test_make_forward_equals_the_model_call():
    """``make_forward(model)(data)`` is ``model(data, train=False,
    with_registration=True)``, key for key and bit for bit."""
    from se3et_tpu_torch.engine.steps import make_forward

    _, model, data = _tiny()
    got = make_forward(model)(data)
    want = model(data, train=False, with_registration=True)
    assert set(got) == set(want) and "estimated_transform" in got
    for key, val in want.items():
        if torch.is_tensor(val):
            assert torch.equal(got[key], val), key
        else:
            assert got[key] is val, key


def test_make_forward_refuses_eval_cfg():
    from se3et_tpu_torch.engine.steps import make_forward

    with pytest.raises(NotImplementedError, match="evaluate"):
        make_forward(object(), eval_cfg=object())


def test_make_forward_matches_jax_make_forward():
    """The port's and JAX's ``make_forward`` on the same converted weights
    and the same numpy pair (the tiny materialised cut, exact math on both
    sides), at ``tests/test_torch_model.py``'s full-forward tolerances:
    coarse features on valid rows within 1e-4 of their scale, the coarse
    correspondences as sets, the matching scores within 1e-3, the transform
    by ``selfcheck.registration_agreement``."""
    import __graft_entry__ as ge
    from se3et_tpu.engine.steps import make_forward as jax_make_forward
    from se3et_tpu.nn.model import SE3ETModel as JaxModel
    from se3et_tpu_torch.convert import load_flax_params
    from se3et_tpu_torch.engine.steps import make_forward
    from se3et_tpu_torch.nn.epn import EPNConfig
    from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors
    from se3et_tpu_torch.ops.kernels import selfcheck

    _, pipeline, jcfg = ge._flagship_configs(tiny=True)
    pipeline = dataclasses.replace(pipeline, patch_k=jcfg.num_points_in_patch)
    jcfg = dataclasses.replace(jcfg, serve_fused_embedding=False)
    data = ge._example_pair(pipeline, num_points=250, seed=3, model_cfg=jcfg)
    data = {k: (np.asarray(v, np.float32)
                if k.startswith("influence_") and k != "influence_sig" else v)
            for k, v in data.items()}
    jmodel = JaxModel(jcfg)
    rngs = {"params": jax.random.PRNGKey(0), "targets": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda d: jmodel.init(rngs, d, train=False, with_gt=False,
                                                  with_registration=False), data)
    params = _random_params(shapes, seed=4)
    want = jax.tree.map(np.asarray, jax.jit(jax_make_forward(jmodel))(params, data))

    fields = dataclasses.asdict(jcfg)
    fields["epn"] = EPNConfig(**fields["epn"])
    port = SE3ETModel(ModelConfig(**fields), device="cpu")
    load_flax_params(port, params)
    got = make_forward(port)(pyramid_to_tensors(data, "cpu"))

    mc = data["masks_3"]
    for i, key in enumerate(("ref_feats_c", "src_feats_c")):
        _close(got[key][torch.from_numpy(mc[i])], want[key][mc[i]], 1e-4)
    _assert_same_correspondences(got, want)
    _assert_scores_close(got, want)
    pair = {"jax": want, "cfg": jcfg}
    ref = dict(_port_lgr_on_jax_inputs(pair),
               estimated_transform=torch.tensor(want["estimated_transform"]))
    ok, text = selfcheck.registration_agreement(got, ref, jcfg.acceptance_radius)
    assert ok, text


# what capture refuses, as the CPU dispatcher shows it: a tensor made from
# host data (on the card a copy from host memory, which waits for the card)
# and a value read back to the host
_HOST_OPS = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero")


class _HostOps(TorchDispatchMode):
    """Records each op of ``_HOST_OPS`` with the port's innermost line that
    called it."""

    def __init__(self):
        super().__init__()
        self.sites = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(_HOST_OPS):
            port = [f for f in traceback.extract_stack() if "se3et_tpu_torch" in f.filename]
            self.sites.append((str(func), port[-1] if port else None))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("route", ["materialised", "flash", "flash_femb", "device_influence"])
def test_serving_forward_has_no_host_round_trip(route):
    """After one warm-up call, the serving forward makes no tensor from host
    data and reads no value back, on the code the card runs.  Left out:
    the kernels' plain versions (``ops/kernels/``: on the card the wrappers
    launch the kernels) and ``F.one_hot``'s bounds check, which PyTorch
    makes on the host for CPU tensors only."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.engine.steps import make_forward
    from se3et_tpu_torch.experiments.configs import (
        make_cfg, serving_config, tiny_config, tiny_flash_config,
    )
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    base = serving_config(make_cfg("se3ete.3dmatch"))
    cfg = tiny_flash_config(base) if route.startswith("flash") else tiny_config(base)
    if route == "flash_femb":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, serve_femb=True))
    pair = synthetic_pair(0, cfg.pipeline, None if route == "device_influence" else cfg.model,
                          600 if route.startswith("flash") else 250, 2.0)
    forward = make_forward(SE3ETModel(cfg.model, device="cpu"))
    data = pyramid_to_tensors(pair, "cpu")
    forward(data)
    with _HostOps() as rec:
        forward(data)
    sites = [(op, f"{f.filename.split('se3et_tpu_torch/')[-1]}:{f.lineno} {f.line}")
             for op, f in rec.sites if f is not None]
    assert len(sites) == len(rec.sites), rec.sites
    left = [s for s in sites if not s[1].startswith("ops/kernels/") and "F.one_hot(" not in s[1]]
    assert not left, left


def test_capture_forward_refuses_a_cpu_model():
    """No CPU or eager fallback: a model off the card cannot be captured."""
    from se3et_tpu_torch.engine.serving import capture_forward

    _, model, data = _tiny()
    with pytest.raises(RuntimeError, match="CUDA device"):
        capture_forward(model, data)


def _mismatch(case, data, bare):
    data = dict(data)
    if case == "missing key":
        del data["node_knn_masks"]
    elif case == "extra key":  # a pair with host influence against a bare example
        data["influence_same_0"] = torch.zeros((2, 128, 8, 15))
    elif case == "bare pair":  # the reverse: a bare pair against a host-influence example
        data = bare
    elif case == "shape":
        data["points_0"] = torch.zeros((2, 127, 3))
    elif case == "dtype":
        data["neighbors_0"] = data["neighbors_0"].long()
    return data


@pytest.mark.parametrize("case,example", [
    ("missing key", "host"), ("extra key", "bare"), ("bare pair", "host"), ("shape", "host"),
    ("dtype", "host"),
])
def test_captured_input_check_raises(case, example):
    """A pair must have exactly the captured example's keys, shapes and
    dtypes."""
    from se3et_tpu_torch.engine.serving import check_inputs, input_spec

    _, _, host = _tiny()
    _, _, bare = _tiny(bare=True)
    spec = input_spec(host if example == "host" else bare)
    check_inputs(spec, host if example == "host" else bare)
    with pytest.raises(ValueError):
        check_inputs(spec, _mismatch(case, host if example == "host" else bare, bare))


@pytest.mark.parametrize("pad_value", [0.0, -1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_gather_with_sentinel_unchanged(pad_value, dtype):
    """``gather_with_sentinel`` fills the pad value without a host tensor and
    gives what its earlier form (``torch.where`` against
    ``torch.as_tensor(pad_value)``) gave, sentinel rows and negative
    indices included, and what the JAX function gives."""
    from se3et_tpu.ops import geometry as jgeo
    from se3et_tpu_torch.ops import geometry

    rng = np.random.RandomState(2)
    vals = torch.from_numpy(rng.normal(size=(12, 4, 3)).astype(np.float32) * 5).to(dtype)
    idx = torch.from_numpy(rng.randint(-2, 14, size=(6, 5)).astype(np.int32))
    idx[0] = 12  # a whole row of sentinels
    got = geometry.gather_with_sentinel(vals, idx, pad_value=pad_value)
    safe = vals[idx.clamp(0, 11).long()]
    mask = ((idx >= 0) & (idx < 12))[..., None, None]
    before = torch.where(mask, safe, torch.as_tensor(pad_value, dtype=safe.dtype))
    assert got.dtype == dtype and torch.equal(got, before)
    assert bool((got[0] == pad_value).all())
    want = np.asarray(jgeo.gather_with_sentinel(vals.float().numpy(), idx.numpy(),
                                                pad_value=pad_value))
    np.testing.assert_array_equal(got.float().numpy(), want)
