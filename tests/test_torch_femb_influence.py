"""The port's last two kernels against the JAX package, on the CPU: the
device influence weights (K15, ``windowed_conv.influence``) and the flash
RPE self-attention with the embedding recomputed in the kernel (K16,
``rpe_attention.rpe_self_attention_femb``), each through its plain
version; and the model's device-influence route against its host-influence
route.

Inputs are made with numpy from a seed; the Pallas kernels run in interpret
mode, as the JAX package's own tests run them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3et_tpu_torch.data import pipeline as port_pipe
from se3et_tpu_torch.ops.kernels import embedding as emb_k
from se3et_tpu_torch.ops.kernels import rpe_attention as rpe_k
from se3et_tpu_torch.ops.kernels import windowed_conv as wc_k

torch.set_num_threads(1)

MODES = ("linear", "constant", "gaussian")


def _t(a):
    return torch.from_numpy(np.array(a))


def _influence_inputs(seed, cap=256, h=7, k=5):
    """One cloud of ``cap`` points, random neighbour rows with sentinels
    (== cap) and the last 5 query rows all sentinels (the pyramid's padded
    rows), kernel points within the neighbourhood."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 0.6, size=(1, cap, 3)).astype(np.float32)
    nbr = rng.randint(0, cap + 1, size=(1, cap, h)).astype(np.int32)
    nbr[:, -5:] = cap
    kp = rng.uniform(-0.1, 0.1, size=(k, 3)).astype(np.float32)
    return pts, nbr, kp


@pytest.mark.parametrize("mode", MODES)
def test_influence_plain_matches_windowed_kernel(mode):
    """K15's plain version == influence_windowed_pallas (interpret, float32
    out) on window maps from the port's build_window_maps over every source
    segment (no neighbour dropped), unsorted over h (the maps keep each
    neighbour's slot): rtol 1e-3, atol 2e-4, the JAX test's tolerance (the
    TPU kernel reads coordinates as double-bf16); sentinel slots and the
    all-sentinel rows give 0."""
    import jax

    from se3et_tpu.ops.pallas import windowed_conv as wc

    pts, nbr, kp = _influence_inputs(3)
    cap = pts.shape[1]
    nseg = cap // port_pipe.WINDOW_SSEG
    seg_idx, local = port_pipe.build_window_maps(nbr[0], cap, nseg)
    assert not ((local >= nseg * port_pipe.WINDOW_SSEG) & (nbr[0] < cap)).any()
    win3 = wc.segment_window_gather(jnp.asarray(pts), jnp.asarray(seg_idx)[None],
                                    precision=jax.lax.Precision.HIGHEST)
    want, want_sum = wc.influence_windowed_pallas(
        jnp.asarray(local)[None], jnp.asarray(pts), win3, jnp.asarray(kp), sigma=0.15,
        influence=mode, interpret=True, out_dtype=jnp.float32)
    got, got_sum = wc_k.influence(_t(pts), _t(pts), _t(nbr), _t(kp), sigma=0.15, mode=mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(want_sum), rtol=1e-3, atol=2e-4)
    assert (got[nbr >= cap] == 0).all() and (got[:, -5:] == 0).all()


@pytest.mark.parametrize("mode", MODES)
def test_influence_plain_matches_xla_influence(mode):
    """K15's plain version == the JAX backbone's _influence_weights (exact
    neighbours), float32 to 1e-5; its H-sum in float32; bf16 output is the
    float32 weights rounded once."""
    from se3et_tpu.nn.epn import _influence_weights

    pts, nbr, kp = _influence_inputs(4)
    q = pts[:, :200]
    want = np.asarray(_influence_weights(jnp.asarray(q), jnp.asarray(pts),
                                         jnp.asarray(nbr[:, :200]), jnp.asarray(kp), 0.15,
                                         mode))
    got, got_sum = wc_k.influence(_t(q), _t(pts), _t(nbr[:, :200]), _t(kp), sigma=0.15,
                                  mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_sum.numpy(), want.sum(axis=2), rtol=1e-5, atol=1e-5)
    got16, _ = wc_k.influence(_t(q), _t(pts), _t(nbr[:, :200]), _t(kp), sigma=0.15, mode=mode,
                              out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got.to(torch.bfloat16))


def _femb_inputs(b=1, ah=6, n=128, c=16, cc=64, ka=3, seed=11):
    """The inputs of tests/test_attention.py's femb test: unit-cube points,
    their angle_k nearest neighbours (self excluded), a masked tail of 7
    keys, projections at scale 0.1."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 1, size=(b, n, 3)).astype(np.float32)
    d2 = ((pts[:, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1)
    knn_idx = np.argsort(d2, axis=2)[:, :, 1:ka + 1]
    knn = np.take_along_axis(pts[:, :, None, :], knn_idx[..., None], axis=1)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    return dict(
        pts=pts, knn=knn, wd=f(cc, cc, sc=0.1), bd=f(cc, sc=0.1), wa=f(cc, cc, sc=0.1),
        ba=f(cc, sc=0.1), q=f(b, ah, n, c), qp=f(b, n, ah, cc, sc=0.3),
        km=(np.arange(n) < n - 7)[None].repeat(b, 0), qw=f(b, 3, ah, n, sc=0.3),
        p4=np.concatenate([pts, np.zeros((b, n, 1), np.float32)], -1).swapaxes(1, 2).copy())


@pytest.mark.parametrize("with_sh", [False, True])
def test_rpe_attention_femb_plain_matches_pallas(with_sh):
    """K16's plain version (float32) == the TPU rpe_self_attention_femb
    (interpret) on valid query rows, with and without the SH term: rtol
    3e-3, atol 3e-3, JAX's own femb-vs-materialised tolerance (the TPU
    kernel rounds its bases, G and the angle max to bf16 and takes atan2 by
    a polynomial)."""
    from se3et_tpu.ops.pallas import rpe_attention as fr

    x = _femb_inputs()
    qw = x["qw"] if with_sh else None
    want = np.asarray(fr.rpe_self_attention_femb(
        *(jnp.asarray(x[k]) for k in ("q", "q", "q", "qp", "km")),
        None if qw is None else jnp.asarray(qw), jnp.asarray(x["p4"]), jnp.asarray(x["knn"]),
        jnp.asarray(x["wd"]), jnp.asarray(x["wa"]), scale=0.25, sigma_d=0.2, sigma_a=15.0,
        interpret=True))
    got = rpe_k.rpe_self_attention_femb(
        *(_t(x[k]) for k in ("q", "q", "q", "qp", "km")), None if qw is None else _t(qw),
        _t(x["p4"]), _t(x["knn"]), _t(x["wd"]), _t(x["wa"]), scale=0.25, sigma_d=0.2,
        sigma_a=15.0)
    assert got.dtype == torch.float32
    valid = x["km"][0]
    np.testing.assert_allclose(got.numpy()[..., valid, :], want[..., valid, :], rtol=3e-3,
                               atol=3e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rpe_attention_femb_plain_matches_k3_k5_route(dtype):
    """K16's plain version == K3's plain embedding (with its biases) fed to
    K5's plain attention, on valid query rows with the SH term.  The biases
    are softmax no-ops; what differs is the diagonal (K16 zeroes the self
    pair's distance by index, K3 takes the expanded form's rounding noise
    there) and, in bf16, K16's rounding of the bases and G to bf16 (K3 keeps
    them float32; both round the embedding row).  Tolerance of the output
    scale: 1e-3 in float32, 1e-2 in bf16 (K5's own)."""
    tdt = getattr(torch, dtype)
    x = _femb_inputs(b=2, ah=4, cc=64, seed=5)
    c = lambda k: _t(x[k]).to(tdt)  # noqa: E731
    emb = emb_k.geometric_embedding_plain(*(_t(x[k]) for k in ("pts", "knn", "wd", "bd", "wa",
                                                              "ba")),
                                          0.2, 15.0, out_dtype=tdt)
    want = rpe_k.rpe_self_attention_plain(c("q"), c("q"), c("q"), c("qp"), emb, _t(x["km"]),
                                          _t(x["qw"]), _t(x["p4"]), scale=0.25)
    got = rpe_k.rpe_self_attention_femb(c("q"), c("q"), c("q"), c("qp"), _t(x["km"]),
                                        _t(x["qw"]), _t(x["p4"]), _t(x["knn"]), _t(x["wd"]),
                                        _t(x["wa"]), scale=0.25, sigma_d=0.2, sigma_a=15.0)
    rows = _t(x["km"])[:, None, :, None].expand_as(want)
    tol = 1e-3 if dtype == "float32" else 1e-2
    err = float((got - want)[rows].abs().max())
    assert err <= tol * float(want[rows].abs().max()), err


def test_rpe_attention_femb_has_no_backward():
    """Serving only, as the TPU kernel: an input that requires grad raises."""
    x = _femb_inputs()
    q = _t(x["q"]).requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        rpe_k.rpe_self_attention_femb(q, q, q, _t(x["qp"]), _t(x["km"]), None, _t(x["p4"]),
                                      _t(x["knn"]), _t(x["wd"]), _t(x["wa"]), scale=0.25,
                                      sigma_d=0.2, sigma_a=15.0)


@pytest.fixture(scope="module")
def influence_routes():
    """One tiny flash pair with and without host influence, and a float32
    model on the CPU."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, tiny_flash_config
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    cfg = tiny_flash_config(serving_config(make_cfg("se3ete.3dmatch")))
    model_cfg = dataclasses.replace(cfg.model, train_fused_conv=True,
                                    train_fused_embedding=True, train_fused_attention=True)
    host = pyramid_to_tensors(synthetic_pair(0, cfg.pipeline, model_cfg, 600, 2.0), "cpu")
    device = {k: v for k, v in host.items() if not k.startswith("influence_")}
    return SE3ETModel(model_cfg, seed=3, device="cpu"), host, device


def _assert_same(got, want, what):
    for key, w in want.items():
        if not torch.is_tensor(w) or not w.is_floating_point():
            continue
        ok = torch.isfinite(w) & (w > -1e6)
        g = got[key].detach()
        err = float((g - w.detach())[ok].abs().max())
        assert err <= 1e-5 * max(float(w.detach()[ok].abs().max()), 1.0), (what, key, err)


@pytest.mark.parametrize("train", [False, True])
def test_device_influence_equals_host_influence(influence_routes, train):
    """float32 on the CPU: the model's outputs on a pyramid without host
    influence (K15's plain version, 7 (stage, set) calls) equal those with
    the host's weights within 1e-5 of their scale, serving (up to the
    Sinkhorn scores; the registration after it is discontinuous in them)
    and the training forward (the backbone, where the influence enters:
    training's embedding is bf16, as in the JAX step, so a float32 rounding
    there can move an embedding value by one bf16 ulp).  The float32 sums
    of the two routes differ by rounding only."""
    from se3et_tpu_torch.nn import epn

    model, host, device = influence_routes
    calls = []
    kernel = epn.influence

    def spy(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **kwargs)

    cut = "backbone" if train else "sinkhorn"
    want = model(host, train=train, stop_after=cut)
    epn.influence = spy
    try:
        got = model(device, train=train, stop_after=cut)
    finally:
        epn.influence = kernel
    assert len(calls) == 7
    _assert_same(got, want, f"train={train}")


def test_entry_config_matches_graft_entry():
    """The port's entry() serves the JAX entry's configuration
    (``_flagship_configs(tiny=False)``) on the port's serving cut (exact
    neighbours), and its pair carries no host influence, as the JAX entry's
    ``_example_pair`` without ``model_cfg``."""
    import __graft_entry__ as ge
    from se3et_tpu_torch.entry import ENTRY_POINTS, entry_config

    _, pipeline, model = ge._flagship_configs(tiny=False)
    got = entry_config()
    assert dataclasses.asdict(got.pipeline) == dataclasses.asdict(
        dataclasses.replace(pipeline, window_segments=0))
    assert dataclasses.asdict(got.model) == dataclasses.asdict(model)
    assert ENTRY_POINTS == 6000
