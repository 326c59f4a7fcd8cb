"""The registration of ``entry()``'s pair under the port's seed-0 weights.

``tests/data/entry_seed0_lgr_inputs.npz`` holds what the port's
``local_global_registration`` receives at ``entry()``'s pair (the
6000-point synthetic pair at the entry caps, without host influence) with
the weights of ``SE3ETModel(entry_config().model, seed=0)`` on the CPU:
the patch points and masks of the 256 node correspondences and their
Sinkhorn log-scores (256, 65, 65).  ``python tests/test_torch_entry_seed0.py``
rebuilds it (a full-width forward on the CPU in one thread, about a minute).

With these untrained weights the log-scores pass log(float32 max), so
exp() gives infinite scores in both packages.  JAX's jitted registration
stays finite on them: XLA computes ``score * mask`` as a selection, so an
infinite score outside the mask weighs 0.  The port multiplied, and inf * 0
is NaN: its transform was NaN.  It now selects as JAX does.
"""

import os
import sys

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "entry_seed0_lgr_inputs.npz")
LGR_INPUTS = ("ref_node_corr_knn_points", "src_node_corr_knn_points",
              "ref_node_corr_knn_masks", "src_node_corr_knn_masks", "matching_scores")


def _settings():
    from se3et_tpu_torch.entry import entry_config

    c = entry_config().model
    return dict(k=c.fine_topk, acceptance_radius=c.acceptance_radius, mutual=c.mutual,
                confidence_threshold=c.confidence_threshold, use_dustbin=c.use_dustbin,
                correspondence_threshold=c.correspondence_threshold,
                correspondence_limit=c.correspondence_limit,
                num_refinement_steps=c.num_refinement_steps)


def _inputs():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in LGR_INPUTS}


def _assert_rigid(tf):
    r = tf[:3, :3]
    assert np.isfinite(tf).all(), tf
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)
    np.testing.assert_array_equal(tf[3], [0.0, 0.0, 0.0, 1.0])


def test_seed0_scores_overflow_exp():
    """The untrained seed-0 weights give valid (unmasked) log-scores above
    log(float32 max): their exp() is infinite, in either package."""
    d = _inputs()
    kk = d["ref_node_corr_knn_masks"].shape[1]
    valid = d["ref_node_corr_knn_masks"][:, :, None] & d["src_node_corr_knn_masks"][:, None, :]
    scores = d["matching_scores"][:, :kk, :kk][valid]
    assert scores.max() > np.log(np.finfo(np.float32).max)
    assert np.isinf(torch.exp(torch.from_numpy(scores)).numpy()).any()


def test_registration_is_finite_on_overflowed_scores_as_in_jax():
    """On those inputs JAX's jitted ``local_global_registration`` and the
    port's both return a finite proper rigid transform (the port's was NaN
    before it masked by selection), though both carry infinite
    correspondence scores.  The two transforms need not agree: with
    infinite weights the fit depends on how top-k breaks ties among them."""
    import jax.numpy as jnp
    from se3et_tpu.nn.matching import local_global_registration as jax_lgr
    from se3et_tpu_torch.nn.matching import local_global_registration

    d, settings = _inputs(), _settings()
    want = jax.tree.map(np.asarray, jax.jit(lambda *a: jax_lgr(*a, **settings))(
        *[jnp.asarray(d[k]) for k in LGR_INPUTS]))
    got = local_global_registration(*[torch.from_numpy(d[k]) for k in LGR_INPUTS], **settings)
    assert np.isinf(want["corr_scores"]).any() and bool(torch.isinf(got["corr_scores"]).any())
    _assert_rigid(want["estimated_transform"])
    _assert_rigid(got["estimated_transform"].numpy())


def _capture():
    """Serve ``entry()``'s pair on the CPU with the seed-0 weights and save
    the registration's inputs to FIXTURE; prints the transform."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.entry import ENTRY_POINTS, entry_config
    from se3et_tpu_torch.experiments.configs import synthetic_extent
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    torch.set_num_threads(1)  # float32 sums in one order
    cfg = entry_config()
    pair = synthetic_pair(0, cfg.pipeline, None, ENTRY_POINTS, synthetic_extent(cfg.data.dataset))
    model = SE3ETModel(cfg.model, seed=0, device="cpu").eval()
    with torch.no_grad():
        out = model(pyramid_to_tensors(pair, "cpu"), with_registration=True, with_gt=True)
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez_compressed(FIXTURE, **{k: out[k].numpy() for k in LGR_INPUTS})
    print(f"wrote {FIXTURE}; estimated_transform\n{out['estimated_transform'].numpy()}")


if __name__ == "__main__":
    _capture()
