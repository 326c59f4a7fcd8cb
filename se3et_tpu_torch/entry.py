r"""Entry point of the PyTorch port, the counterpart of the JAX package's
``__graft_entry__.entry()``: the flagship SE3ET-E model (``se3ete.3dmatch``
on the port's serving cut, exact neighbours) at stage caps (8192, 4096,
1024, 768) with random weights drawn from the experiment's seed, and one
6000-point synthetic pair built without host influence weights, so the
model computes them on the card (kernel K15), as the JAX entry's pair
leaves them to the device.

    from se3et_tpu_torch.entry import entry
    fn, (model, data) = entry()
    out = fn(model, data)   # out["estimated_transform"] (4, 4)

The model and the pair are built on the card unless ``device`` says
otherwise.  The JAX module's ``dryrun_multichip`` (a data-parallel training
step over several devices) has no counterpart yet.
"""

from __future__ import annotations

import dataclasses

ENTRY_POINTS = 6000


def entry_config():
    """``se3ete.3dmatch`` on the port's serving cut with the JAX entry's
    stage caps and coarse cap."""
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config

    cfg = serving_config(make_cfg("se3ete.3dmatch"))
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, stage_caps=(8192, 4096, 1024, 768), coarse_point_cap=768))


def entry(device="cuda"):
    """(fn, (model, data)): ``fn(model, data)`` serves the pair with the
    registration and the ground-truth overlaps, the JAX entry call's
    outputs."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import synthetic_extent
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    cfg = entry_config()
    # the experiment's seed: with the untrained weights of seed 0 this pair's
    # Sinkhorn log-scores pass log(float32 max), so exp() makes some of the
    # registration's weights infinite and its transform meaningless, in JAX
    # too (tests/test_torch_entry_seed0.py)
    model = SE3ETModel(cfg.model, seed=cfg.seed, device=device).eval()
    pair = synthetic_pair(0, cfg.pipeline, None, ENTRY_POINTS, synthetic_extent(cfg.data.dataset))
    data = pyramid_to_tensors(pair, device)

    def fn(model, data):
        return model(data, with_registration=True, with_gt=True)

    return fn, (model, data)
