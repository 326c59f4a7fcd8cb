"""The port's entry point against the JAX package's, and the model options
the port refuses rather than ignores.

The entry test serves ``se3et_tpu_torch.entry.entry()`` on the CPU with the
flax ``PRNGKey(0)`` weights of ``__graft_entry__.entry()`` (converted by
``convert.load_flax_params``) and holds it against that JAX call on its own
pair: the port's pair is the same synthetic 6000-point pair without host
influence, the port's weights the same values.  It runs the full-width JAX
forward on the CPU (minutes), so it is marked ``slow``.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("field", ["backbone_remat"])
def test_model_refuses_options_it_does_not_port(field):
    """An option the port does not implement raises at construction; the
    config keeps the field, equal to the JAX package's default."""
    from se3et_tpu.nn.model import ModelConfig as JaxModelConfig
    from se3et_tpu_torch.experiments.configs import make_cfg
    from se3et_tpu_torch.nn.model import SE3ETModel

    cfg = make_cfg("se3ete.3dmatch").model
    assert getattr(cfg, field) == getattr(JaxModelConfig(), field)
    with pytest.raises(NotImplementedError, match=field):
        SE3ETModel(dataclasses.replace(cfg, **{field: True}), device="cpu")


@pytest.mark.slow
def test_entry_matches_jax_entry_on_the_same_weights():
    """Same pair, same weights: the transform by
    ``selfcheck.registration_agreement`` and the largest matching score
    within 1e-3, printed beside the transform."""
    import __graft_entry__ as ge
    from se3et_tpu_torch.convert import load_flax_params
    from se3et_tpu_torch.entry import entry
    from se3et_tpu_torch.ops.kernels import selfcheck

    t0 = time.perf_counter()
    jfn, (params, jdata) = ge.entry()
    want = jax.tree.map(np.asarray, jfn(params, jdata))
    jax_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    fn, (model, data) = entry(device="cpu")
    load_flax_params(model, params)
    for key in ("points_0", "points_3"):
        np.testing.assert_array_equal(data[key].numpy(), np.asarray(jdata[key]))
    with torch.no_grad():
        got = fn(model, data)
    port_s = time.perf_counter() - t0

    # the matching scores are per chosen node correspondence, which top-k
    # ties may order or pick differently: held by their largest value
    ws, gs = want["matching_scores"], got["matching_scores"].numpy()
    top_w = float(ws[np.isfinite(ws) & (ws > -1e6)].max())
    top_g = float(gs[np.isfinite(gs) & (gs > -1e6)].max())
    print(f"JAX entry {jax_s:.1f} s, port {port_s:.1f} s on the CPU; largest matching "
          f"score JAX {top_w:.4f} port {top_g:.4f}")
    assert abs(top_g - top_w) <= 1e-3
    # JAX's outputs carry no inlier masks: its final inliers are its valid
    # correspondences that its transform aligns within the acceptance radius
    cfg = ge._flagship_configs(tiny=False)[2]
    tw = np.asarray(want["estimated_transform"])
    src, ref = np.asarray(want["src_corr_points"]), np.asarray(want["ref_corr_points"])
    res = np.linalg.norm(src @ tw[:3, :3].T + tw[:3, 3] - ref, axis=-1)
    jax_reg = {k: torch.from_numpy(np.asarray(want[k])) for k in (
        "ref_corr_points", "src_corr_points", "corr_valid", "estimated_transform")}
    jax_reg["corr_inliers"] = torch.from_numpy(
        np.asarray(want["corr_valid"]) & (res < cfg.acceptance_radius))
    ok, text = selfcheck.registration_agreement(got, jax_reg, cfg.acceptance_radius)
    print(f"transform: {text}")
    assert ok, text
