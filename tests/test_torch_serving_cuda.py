"""The captured serving forward (``engine/serving.py``) against the eager
forward on the card, bit for bit: at the tiny float32 cuts on every
serving route the port has, and at the JAX entry's full-width bf16 cut,
where K14's tensor-core form (its queue counter zeroed by a memset inside
the graph) and K6/K7's TMA forms (tensor maps encoded at capture) run;
the captured eval forward (``capture_forward(model, example, eval_cfg)``:
the ground truth and the metrics inside the graph) on the tiny cuts of
SE3ET-E and SE3ET-I and on ``se3eti.3dmatch`` at full width, and the
``Tester`` on the card.
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
    ``serve_fused_conv=False``; with ``_I`` those of se3eti.3dmatch), or
    ``entry_width``: se3ete.3dmatch in bf16 at the JAX entry's stage caps
    with host influence, 6000 points; ``se3eti_width``: se3eti.3dmatch in
    bf16 at its stage caps with host influence, 6000 points."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.entry import ENTRY_POINTS, entry_config
    from se3et_tpu_torch.experiments.configs import (
        make_cfg, serving_config, tiny_config, tiny_flash_config,
    )
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    se3eti = route.endswith("_I") or route.startswith("se3eti")
    base = serving_config(make_cfg("se3eti.3dmatch" if se3eti else "se3ete.3dmatch"))
    points = 600 if route.startswith("flash") else 250
    if route == "entry_width":
        cfg, points = entry_config(), ENTRY_POINTS
    elif route == "se3eti_width":
        cfg, points = base, 6000
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
    (NaNs and signed zeros included), nested dicts (the metrics) too."""
    assert set(got) == set(want), what
    for key, val in want.items():
        if torch.is_tensor(val):
            assert got[key].dtype == val.dtype and got[key].shape == val.shape, (what, key)
            assert torch.equal(_bits(got[key]), _bits(val)), (what, key)
        elif isinstance(val, dict):
            _assert_bitwise(got[key], val, f"{what} {key}")
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


@pytest.mark.parametrize("route", ["materialised", "flash", "flash_I", "se3eti_width"])
def test_eval_replay_equals_eager(cuda, route):
    """The eval forward captured on pair 0 (``gt_overlap_mat`` and the
    metrics inside the graph) replays both pairs bit for bit against the
    eager ``make_forward(model, eval_cfg)``, metrics included and finite;
    at ``se3eti_width`` the self_eq layers' shape (AH = 24, no SH term)
    takes K5's ws form."""
    from se3et_tpu_torch.engine.serving import capture_forward
    from se3et_tpu_torch.engine.steps import make_forward
    from se3et_tpu_torch.experiments.configs import make_cfg
    from se3et_tpu_torch.ops.kernels import rpe_attention as rpe

    eval_cfg = make_cfg("se3eti.3dmatch").eval
    model, pairs = _route(route, cuda)
    forward = make_forward(model, eval_cfg)
    eager = [forward(p) for p in pairs]
    if route == "se3eti_width":
        m = model.cfg
        assert rpe.rpe_attention_form(m.kanchor * m.num_heads, m.gt_hidden_dim // m.num_heads,
                                      m.gt_hidden_dim, torch.bfloat16) == "ws"
    served = capture_forward(model, pairs[0], eval_cfg)
    for i in (0, 1, 0):
        _assert_bitwise(served(pairs[i]), eager[i], f"{route} eval pair {i}")
    for out in eager:
        assert set(out["metrics"]) == {"PIR", "IR", "RRE", "RTE", "RMSE", "RR"}
        assert all(bool(torch.isfinite(v)) for v in out["metrics"].values())


def test_tester_on_the_card(cuda, tmp_path):
    """The Tester on the card captures the eval forward at its first pair
    and replays it for the second; its summary is the mean of the eager
    eval forward's metrics and its dumps hold the eager transforms."""
    import numpy as np

    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.engine.steps import make_forward
    from se3et_tpu_torch.engine.tester import Tester
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, tiny_config
    from se3et_tpu_torch.nn.model import pyramid_to_tensors

    cfg = tiny_config(serving_config(make_cfg("se3eti.3dmatch")))
    pairs = [synthetic_pair(i, cfg.pipeline, cfg.model, 250, 2.0) for i in range(2)]
    tester = Tester(cfg.model, cfg.eval, str(tmp_path))
    model, _ = _route("materialised_I", cuda)
    tester.build(model.state_dict())
    summary = tester.run(((dict(p), {"scene_name": "s"}) for p in pairs))
    assert tester.captured is not None and tester.captured.launches["gather_wf_mm"] > 0
    eager = [make_forward(tester.model, cfg.eval)(pyramid_to_tensors(p, cuda)) for p in pairs]
    for key in ("PIR", "IR", "RRE", "RTE", "RMSE", "RR"):
        want = np.mean([float(e["metrics"][key]) for e in eager])
        assert abs(summary[key] - want) <= 1e-6 * max(1.0, abs(want)), key
    for i, e in enumerate(eager):
        dump = np.load(tmp_path / "features" / "test" / "s" / f"{i}_{i}.npz")
        np.testing.assert_array_equal(dump["estimated_transform"],
                                      e["estimated_transform"].cpu().numpy())
