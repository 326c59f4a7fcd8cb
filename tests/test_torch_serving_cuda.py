"""The captured serving forward (``engine/serving.py``) against the eager
forward on the card, bit for bit: at the tiny float32 cuts on every
serving route the port has, and at the JAX entry's full-width bf16 cut,
where K14's tensor-core form (its queue counter zeroed by a memset inside
the graph) and K6/K7's TMA forms (tensor maps encoded at capture) run.
Skipped where no CUDA device is present; run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_serving_cuda.py``.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu

ROUTES = ("materialised", "flash", "flash_femb", "device_influence", "unfused_conv",
          "entry_width")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _route(route, cuda):
    """(model on the card, two pairs as card tensors) for ``route``: the
    tiny float32 cuts (materialised, flash, flash with ``serve_femb``,
    materialised without host influence so K15 runs, materialised with
    ``serve_fused_conv=False``), or ``entry_width``: se3ete.3dmatch in bf16
    at the JAX entry's stage caps with host influence, 6000 points."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.entry import ENTRY_POINTS, entry_config
    from se3et_tpu_torch.experiments.configs import (
        make_cfg, serving_config, tiny_config, tiny_flash_config,
    )
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    base = serving_config(make_cfg("se3ete.3dmatch"))
    points = 600 if route.startswith("flash") else 250
    if route == "entry_width":
        cfg, points = entry_config(), ENTRY_POINTS
    elif route.startswith("flash"):
        cfg = tiny_flash_config(base)
    else:
        cfg = tiny_config(base)
    model_cfg = cfg.model
    if route == "flash_femb":
        model_cfg = dataclasses.replace(model_cfg, serve_femb=True)
    if route == "unfused_conv":
        model_cfg = dataclasses.replace(model_cfg, serve_fused_conv=False)
    host = None if route == "device_influence" else model_cfg
    pairs = [pyramid_to_tensors(synthetic_pair(i, cfg.pipeline, host, points, 2.0), cuda)
             for i in range(2)]
    return SE3ETModel(model_cfg, seed=3, device=cuda).eval(), pairs


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8) if t.is_floating_point() else t


def _assert_bitwise(got, want, what):
    """Every key of ``want`` in ``got`` with the same dtype, shape and bits
    (NaNs and signed zeros included)."""
    assert set(got) == set(want), what
    for key, val in want.items():
        if torch.is_tensor(val):
            assert got[key].dtype == val.dtype and got[key].shape == val.shape, (what, key)
            assert torch.equal(_bits(got[key]), _bits(val)), (what, key)
        else:
            assert got[key] is val, (what, key)


@pytest.mark.parametrize("route", ROUTES)
def test_replay_equals_eager(cuda, route):
    """Captured on pair 0, the graph replays pair 0 and then pair 1, each
    equal bit for bit, every output key, to the eager forward on the same
    pair; pair 0 replayed once more still equals it."""
    from se3et_tpu_torch.engine.serving import capture_forward
    from se3et_tpu_torch.engine.steps import make_forward

    model, pairs = _route(route, cuda)
    forward = make_forward(model)
    eager = [forward(p) for p in pairs]
    served = capture_forward(model, pairs[0])
    for i in (0, 1, 0):
        _assert_bitwise(served(pairs[i]), eager[i], f"{route} pair {i}")
    assert torch.isfinite(eager[1]["estimated_transform"]).all()


def test_replay_runs_the_route_kernels(cuda):
    """At the entry width the capture records K14 (tc form, queue) and K6 /
    K7 (tc forms, TMA maps) with the eager forward's launch counts, and
    K15 stays out (the pairs carry host influence)."""
    from se3et_tpu_torch.engine.serving import capture_forward
    from se3et_tpu_torch.engine.steps import make_forward
    from se3et_tpu_torch.ops.kernels import selfcheck
    from se3et_tpu_torch.ops.kernels import windowed_conv as wc

    model, pairs = _route("entry_width", cuda)
    forward = make_forward(model)
    forward(pairs[0])
    for w in selfcheck.WRAPPERS.values():
        w.launches = 0
    forward(pairs[0])
    eager = {n: w.launches for n, w in selfcheck.WRAPPERS.items()}
    served = capture_forward(model, pairs[0])
    assert served.launches == eager
    assert eager["gather_wf_max"] == 1 and eager["influence"] == 0
    assert eager["eq_attention_stats"] == eager["eq_attention_apply"] == 4
    nbr = pairs[0]["subsampling_1"]
    assert wc.gather_wf_max_form(nbr.shape[2], torch.bfloat16, 384, 1536) == "tc"
    assert served.capture_ms > 0


def test_replayed_outputs_stay_the_callers(cuda):
    """The tensors one replay returns are the caller's: the next replay, on
    another pair, leaves them unchanged."""
    from se3et_tpu_torch.engine.serving import capture_forward

    model, pairs = _route("flash", cuda)
    served = capture_forward(model, pairs[0])
    first = served(pairs[0])
    kept = {k: v.clone() for k, v in first.items() if torch.is_tensor(v)}
    second = served(pairs[1])
    assert not torch.equal(second["ref_feats_c"], first["ref_feats_c"])
    _assert_bitwise({k: first[k] for k in kept}, kept, "first replay's outputs")


def test_captured_input_check_on_the_card(cuda):
    """A pair without host influence cannot meet a graph captured with it."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.engine.serving import capture_forward
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, tiny_config
    from se3et_tpu_torch.nn.model import pyramid_to_tensors

    model, pairs = _route("materialised", cuda)
    served = capture_forward(model, pairs[0], warmup=1)
    cfg = tiny_config(serving_config(make_cfg("se3ete.3dmatch")))
    bare = pyramid_to_tensors(synthetic_pair(0, cfg.pipeline, None, 250, 2.0), cuda)
    with pytest.raises(ValueError, match="influence_same_0"):
        served(bare)
