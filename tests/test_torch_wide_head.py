"""The wide-head family (``se3ete2`` / ``se3eti2``: head width 32) of the
PyTorch port against the JAX package, on the CPU.

The attention kernels K5, K6, K7 and K16 at head width 32: their plain
versions (what the port's wrappers take on the CPU) against the TPU
kernels in interpret mode on the same float32 numpy inputs, as
``tests/test_torch_attention.py`` holds them at head width 16.  Then the
whole forward of a tiny cut of ``se3ete2.3dmatch`` and of
``se3eti2.3dmatch`` that keeps the family's transformer width 128 (head
width 32) and group norm of 16 groups (``tiny_config``), on the
materialised and flash routes (se3ete2 also on the ``serve_femb`` route),
cut at each ``stop_after`` point and held against the JAX forward with
converted weights, as ``tests/test_torch_model.py`` holds SE3ET-E and
SE3ET-I.  Also: K11's plain version at head width 32 (its first design's
form) against the JAX VJP, and the KITTI entry's test path raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3et_tpu.ops.pallas import eq_attention as jeq
from se3et_tpu.ops.pallas import rpe_attention as jrpe
from se3et_tpu_torch.ops.kernels import eq_attention as eq_k
from se3et_tpu_torch.ops.kernels import rpe_attention as rpe_k
from tests.test_torch_attention import _close, _eq_inputs, _rpe_inputs, _t
from tests.test_torch_model import (
    _assert_same_correspondences, _assert_scores_close, _port_lgr_on_jax_inputs,
    _random_params,
)

torch.set_num_threads(1)

HEAD_WIDTH = 32
WIDE = ("se3ete2.3dmatch", "se3eti2.3dmatch")


@pytest.mark.parametrize("ah", [24, 4])
@pytest.mark.parametrize("with_sh", [False, True])
def test_rpe_self_attention_plain_matches_pallas_at_head_width_32(ah, with_sh):
    """K5's plain version == the TPU kernel (interpret mode) at head width
    32, at the self_eq layers' AH = 24 and the plain self layers' AH = 4,
    with and without the SH term, on masked keys; the tolerance of head
    width 16 (rtol 2e-3, atol 2e-4: the TPU kernel's r^2 expansion)."""
    x = _rpe_inputs(20 + ah, ah=ah, c=HEAD_WIDTH, cc=64)
    qw = x["qw"] if with_sh else None
    pts = x["points"] if with_sh else None
    want = np.asarray(jrpe.rpe_self_attention(
        *(jnp.asarray(x[k]) for k in ("q", "k", "v", "qp", "emb", "km")),
        None if qw is None else jnp.asarray(qw), None if pts is None else jnp.asarray(pts),
        scale=HEAD_WIDTH ** -0.5, block_n=64, block_m=128, interpret=True))
    got = rpe_k.rpe_self_attention(
        *(_t(x[k]) for k in ("q", "k", "v", "qp", "emb", "km")),
        None if qw is None else _t(qw), None if pts is None else _t(pts),
        scale=HEAD_WIDTH ** -0.5)
    assert got.shape == (2, ah, 128, HEAD_WIDTH) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("ah,with_sh", [(24, True), (4, False)])
def test_rpe_attention_femb_plain_matches_pallas_at_head_width_32(ah, with_sh):
    """K16's plain version (float32) == the TPU rpe_self_attention_femb
    (interpret mode) at head width 32 and C = 128, at se3ete2's self_eq
    layers' AH = 24 with the SH term and its plain self layers' AH = 4
    without, N = 128 with a masked tail, on valid query rows: rtol and atol
    3e-3, tests/test_torch_femb_influence.py's (the TPU kernel rounds its
    bases, G and the angle max to bf16).  In bf16 the card takes K16's ws
    form at both shapes."""
    from se3et_tpu.ops.pallas import rpe_attention as fr
    from tests.test_torch_femb_influence import _femb_inputs

    cc = 128
    assert rpe_k.rpe_attention_form(ah, HEAD_WIDTH, cc, torch.bfloat16, femb=True) == "ws"
    x = _femb_inputs(ah=ah, c=HEAD_WIDTH, cc=cc, seed=50 + ah)
    qw = x["qw"] if with_sh else None
    kw = dict(scale=HEAD_WIDTH ** -0.5, sigma_d=0.2, sigma_a=15.0)
    want = np.asarray(fr.rpe_self_attention_femb(
        *(jnp.asarray(x[k]) for k in ("q", "q", "q", "qp", "km")),
        None if qw is None else jnp.asarray(qw), jnp.asarray(x["p4"]), jnp.asarray(x["knn"]),
        jnp.asarray(x["wd"]), jnp.asarray(x["wa"]), interpret=True, **kw))
    got = rpe_k.rpe_self_attention_femb(
        *(_t(x[k]) for k in ("q", "q", "q", "qp", "km")), None if qw is None else _t(qw),
        _t(x["p4"]), _t(x["knn"]), _t(x["wd"]), _t(x["wa"]), **kw)
    assert got.shape == (1, ah, 128, HEAD_WIDTH) and got.dtype == torch.float32
    valid = x["km"][0]
    np.testing.assert_allclose(got.numpy()[..., valid, :], want[..., valid, :], rtol=3e-3,
                               atol=3e-3)


@pytest.mark.parametrize("positive,sup", [
    ("sq", False), ("sq", True), ("softplus", False), ("softplus", True), ("minus", True),
    ("sigmoid", True),
])
def test_eq_attention_stats_plain_matches_pallas_at_head_width_32(positive, sup):
    """K6's plain version == the TPU kernel (interpret mode) at head width
    32 and H = 4 (the wide-head family's EQ cross layers), in the positive()
    modes of its entries (``sq``, and ``softplus`` / ``minus`` /
    ``sigmoid``), with and without the supervision max; rtol 1e-5, atol
    1e-5 of the output scale, as at head width 16."""
    x = _eq_inputs(30, h=4, c=HEAD_WIDTH)
    args = [jnp.asarray(x[k]) for k in ("q", "k", "qm", "km")]
    port = [_t(x[k]) for k in ("q", "k", "qm", "km")]
    if sup:
        want = jeq.eq_attention_stats(*args, jnp.asarray(x["sq"])[..., None],
                                      jnp.asarray(x["sk"])[..., None], positive=positive,
                                      with_sup=True, interpret=True)
        got = eq_k.eq_attention_stats(*port, _t(x["sq"]), _t(x["sk"]), positive=positive)
    else:
        want = jeq.eq_attention_stats(*args, positive=positive, interpret=True)
        got = eq_k.eq_attention_stats(*port, positive=positive)
    assert len(got) == len(want) == (4 if sup else 3)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_eq_attention_apply_plain_matches_pallas_at_head_width_32(dtype, tol):
    """K7's plain version == the TPU kernel (interpret mode) at head width
    32 and H = 4 with the TPU kernel's row statistics and the same weights.
    float32: rtol 1e-5, atol 1e-5 of the output scale.  bf16 (the serving
    dtype, whose form on the card is "tc"): q, k, v in bf16 on both sides,
    p rounded to bf16 before p v on both (the TPU kernel's
    ``p.astype(v.dtype)``, the plain version's ``.to(v.dtype)``); rtol and
    atol 1e-2 of the output scale, the bf16 K7's tolerance, since an exp one
    float32 ulp apart can round p to another bf16 value."""
    x = _eq_inputs(31, h=4, c=HEAD_WIDTH)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = {k: jnp.asarray(x[k]).astype(jdt) for k in ("q", "k", "v")}
    rowmax, rowsum, _ = jeq.eq_attention_stats(
        jx["q"], jx["k"], jnp.asarray(x["qm"]), jnp.asarray(x["km"]), interpret=True)
    want = jeq.eq_attention_apply(
        jx["q"], jx["k"], jx["v"], jnp.asarray(x["w"]), rowmax, rowsum,
        jnp.asarray(x["km"]), interpret=True)
    got = eq_k.eq_attention_apply(*(_t(x[k]).to(dtype) for k in ("q", "k", "v")),
                                  _t(x["w"]), _t(rowmax), _t(rowsum), _t(x["km"]))
    assert got.shape[-1] == HEAD_WIDTH and got.dtype == torch.float32
    if dtype == torch.bfloat16:
        assert eq_k.eq_attention_apply_form(4, HEAD_WIDTH, dtype) == "tc"
    _close(got, np.asarray(want, dtype=np.float32), tol)


@pytest.mark.parametrize("ah,with_sh", [(24, True), (4, False), (24, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k11_plain_matches_jax_vjp_at_head_width_32(ah, with_sh, dtype):
    """K11 at head width 32 (the wide-head family's training: se3ete2's
    self_eq layers at AH = 24 with the SH term, its plain self layers at AH
    = 4, se3eti2's self_eq layers at AH = 24 without): its form is the tc
    form in bf16 and the first design ("cuda") in float32, and its plain
    version with the contractions after it
    (what the wrapper takes on the CPU, and K5's autograd backward) matches
    the JAX VJP of ``rpe_self_attention_trainable`` (interpret mode, block
    64 x 128) at N = 128, C = 128 with masked keys, in every gradient (dq,
    dk, dv, dqp, d_emb, dqw).  float32: within 1e-4 of each gradient's
    scale (the head-width-16 test's); bf16 (inputs rounded to bf16 on both
    sides, the port's gradients returned in bf16): within 1e-2 of each
    gradient's scale, the tolerance of K11 in bf16."""
    from se3et_tpu.ops.pallas.rpe_attention import rpe_self_attention_trainable
    from tests.test_torch_train_kernels import _close as _close_scaled
    from tests.test_torch_train_kernels import _rpe_inputs as _rpe_bwd_inputs

    cc = 128
    assert rpe_k.rpe_attention_bwd_form(ah, HEAD_WIDTH, cc, dtype) == (
        "tc" if dtype == torch.bfloat16 else "cuda")
    q, k, v, qp, emb, masks, qw, pts = _rpe_bwd_inputs(True, seed=40 + ah, ah=ah,
                                                       c=HEAD_WIDTH, cc=cc)
    if not with_sh:
        qw = pts = None
    if dtype == torch.bfloat16:
        q, k, v, qp, emb = (torch.from_numpy(a).to(dtype).float().numpy()
                            for a in (q, k, v, qp, emb))
    scale = HEAD_WIDTH ** -0.5
    d_out = np.random.RandomState(41).randn(*q.shape).astype(np.float32)
    diff = (q, k, v, qp, emb) + ((qw,) if with_sh else ())

    def jfn(*a):
        return rpe_self_attention_trainable(a[0], a[1], a[2], a[3], a[4], masks,
                                            a[5] if with_sh else None, pts, scale, 64, 128,
                                            True)

    _, vjp = jax.vjp(jfn, *diff)
    want = vjp(d_out)
    tq = [torch.from_numpy(a).to(dtype) for a in diff[:5]]
    tqw = torch.from_numpy(qw) if with_sh else None
    tpts = torch.from_numpy(pts) if with_sh else None
    tm = torch.from_numpy(masks)
    out, lse = rpe_k.rpe_self_attention_plain(*tq, tm, tqw, tpts, scale=scale, with_lse=True)
    got = rpe_k.rpe_attention_bwd(*tq, tm, tqw, tpts, torch.from_numpy(d_out), out, lse,
                                  scale=scale)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, g, w in zip(("dq", "dk", "dv", "dqp", "demb", "dqw"), got, want):
        if name == "dqw" and not with_sh:
            assert g is None
            continue
        assert g.dtype == (torch.float32 if name == "dqw" else dtype), name
        _close_scaled(g.float(), w, tol)
    leaves = [t.clone().requires_grad_(True) for t in tq]
    lqw = tqw.clone().requires_grad_(True) if with_sh else None
    o = rpe_k.rpe_self_attention(*leaves, tm, lqw, tpts, scale=scale)
    o.backward(torch.from_numpy(d_out))
    for t, g in zip(leaves + ([lqw] if with_sh else []), got):
        assert torch.equal(t.grad, g)


def test_evalkitti_test_path_raises():
    """``se3eti2.3dmatch.evalkitti`` is registered, but its test path raises
    naming the unported KITTI loader rather than serving synthetic 3DMatch
    pairs; nothing is written."""
    import os

    from se3et_tpu_torch.experiments import runner
    from se3et_tpu_torch.experiments.configs import make_cfg

    cfg = make_cfg("se3eti2.3dmatch.evalkitti")
    assert cfg.data.dataset == "kitti"
    with pytest.raises(NotImplementedError, match="KITTI loader"):
        runner.run_test(cfg, ["--max_pairs", "1", "--device", "cpu"])
    assert not os.path.exists(cfg.output_dir)


def _jax_tiny(name, flash):
    """JAX's model config and pipeline of the tiny cut of ``name``: the
    JAX entry with __graft_entry__'s tiny flagship settings, the family's
    transformer width (head width 32) and group norm kept."""
    import __graft_entry__ as ge
    from se3et_tpu.experiments import make_cfg as jax_make_cfg

    flagship, pipeline, tiny = ge._flagship_configs(tiny=True)
    # every setting the tiny flagship changes, on this entry's model
    changed = {f.name: getattr(tiny, f.name) for f in dataclasses.fields(tiny)
               if getattr(tiny, f.name) != getattr(flagship.model, f.name)}
    changed.update(init_dim=32, gt_input_dim=512, gt_hidden_dim=128, gt_output_dim=128,
                   group_norm=16)
    jcfg = dataclasses.replace(jax_make_cfg(name).model, **changed)
    pipeline = dataclasses.replace(pipeline, patch_k=jcfg.num_points_in_patch)
    if flash:
        pipeline = dataclasses.replace(pipeline, stage_caps=(256, 192, 160, 128),
                                       coarse_point_cap=128)
        jcfg = dataclasses.replace(jcfg, serve_fused_attention=True)
    return jcfg, pipeline


@pytest.mark.parametrize("name", WIDE)
@pytest.mark.parametrize("flash", [False, True])
def test_tiny_config_keeps_the_family_head_width(name, flash):
    """The port's tiny cut of the wide-head entries equals JAX's entry
    under the tiny flagship's settings with the family's widths kept:
    transformer width 128 over 4 heads (head width 32), group norm 16."""
    from se3et_tpu_torch.experiments.configs import make_cfg, tiny_config, tiny_flash_config

    jcfg, pipeline = _jax_tiny(name, flash)
    got = (tiny_flash_config if flash else tiny_config)(make_cfg(name))
    assert dataclasses.asdict(got.model) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(got.pipeline) == dataclasses.asdict(pipeline)
    assert got.model.gt_hidden_dim // got.model.num_heads == HEAD_WIDTH


# the femb route's features after the transformer: JAX's bf16 self layers
# against the port's float32 ones (tests/test_torch_model.py's
# _TRANSFORMER_RTOL); every other route and cut at the float32 tolerances
_TRANSFORMER_RTOL = {"flash_femb": 3e-3}


@pytest.fixture(scope="module", params=[f"{route}-{name.split('.')[0]}" for name in WIDE
                                        for route in ("materialised", "flash")]
                + ["flash_femb-se3ete2"])
def pair(request):
    """One tiny pair through both packages with the same numpy weights: the
    JAX forward (and its backbone) against the port cut at each
    ``stop_after`` point (float32, the XLA embedding route on the JAX side
    as in tests/test_torch_model.py).  ``flash_femb``: the flash route with
    ``serve_femb`` on both sides, so the self layers rebuild their
    embedding rows in K16 (JAX: ``rpe_self_attention_femb`` in interpret
    mode; the port: its plain version) at head width 32."""
    import __graft_entry__ as ge
    from se3et_tpu.nn.model import SE3ETModel as JaxModel
    from se3et_tpu_torch.convert import load_flax_params
    from se3et_tpu_torch.nn.epn import EPNConfig
    from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors

    route, family = request.param.split("-")
    flash = route.startswith("flash")
    jcfg, pipeline = _jax_tiny(f"{family}.3dmatch", flash)
    jcfg = dataclasses.replace(jcfg, serve_fused_embedding=False,
                               serve_femb=route == "flash_femb")
    data = ge._example_pair(pipeline, num_points=600 if flash else 250, seed=0,
                            model_cfg=jcfg)
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
        "route": route,
        "cfg": jcfg,
        "data": data,
        "jax": run(""),
        "jax_backbone": run("backbone"),
        "port": {cut: port(tdata, stop_after=cut)
                 for cut in ("backbone", "transformer", "matching", "sinkhorn", "")},
    }


def _close_rows(got, want, rtol):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_backbone_matches_jax(pair):
    """feats_f / feats_c on valid points, rtol 1e-4 of the output scale
    (tests/test_torch_model.py's)."""
    m1, mc = pair["data"]["masks_1"], pair["data"]["masks_3"]
    want, got = pair["jax_backbone"], pair["port"]["backbone"]
    assert got["feats_c"].shape[-1] == pair["cfg"].init_dim * 16
    _close_rows(got["feats_f"][torch.from_numpy(m1)], want["feats_f"][m1], 1e-4)
    _close_rows(got["feats_c"][torch.from_numpy(mc)], want["feats_c"][mc], 1e-4)


def test_transformer_matches_jax(pair):
    """Normalised coarse features after the transformer (width 128, head
    width 32), rtol 1e-4 of the output scale (the femb route: see
    _TRANSFORMER_RTOL)."""
    mc = pair["data"]["masks_3"]
    got = pair["port"]["transformer"]
    rtol = _TRANSFORMER_RTOL.get(pair["route"], 1e-4)
    for i, key in enumerate(("ref_feats_c", "src_feats_c")):
        assert got[key].shape[-1] == 128
        _close_rows(got[key][torch.from_numpy(mc[i])], pair["jax"][key][mc[i]], rtol)


def test_superpoint_correspondences_match_as_sets(pair):
    """The valid coarse correspondences (the ``matching`` cut) are JAX's as
    a set."""
    _assert_same_correspondences(pair["port"]["matching"], pair["jax"])


def test_matching_scores_match_jax(pair):
    """Sinkhorn log-probabilities (the ``sinkhorn`` cut) per correspondence
    on valid entries incl. the dustbins, to 1e-3."""
    _assert_scores_close(pair["port"]["sinkhorn"], pair["jax"])


def test_estimated_transform_matches_jax(pair):
    """The full forward: correspondences and scores as above, and the
    transform held as ``tests/test_torch_model.py`` holds it
    (``selfcheck.registration_agreement`` against JAX's, with JAX's
    decisions from the port's registration on JAX's own inputs)."""
    from se3et_tpu_torch.ops.kernels import selfcheck

    got = pair["port"][""]
    _assert_same_correspondences(got, pair["jax"])
    _assert_scores_close(got, pair["jax"])
    want = dict(_port_lgr_on_jax_inputs(pair),
                estimated_transform=torch.from_numpy(pair["jax"]["estimated_transform"]))
    ok, text = selfcheck.registration_agreement(got, want, pair["cfg"].acceptance_radius)
    assert ok, text
