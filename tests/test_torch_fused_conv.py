"""The port's fused serving convs (K12-K14, ``serve_fused_conv``) against
the JAX package, on the CPU.

* Each kernel's plain version against its TPU kernel in interpret mode
  (K12 ``windowed_gather_wf_mm``, K13 ``windowed_gather_wf_max_mm``, K14
  ``windowed_gather_wf_max``), on window maps from the port's copy of
  ``build_window_maps`` that cover every source segment (no neighbour
  dropped), in float32 and in bf16.
* The slice as a whole: the port's backbone on its fused route against the
  JAX backbone on its windowed route (window maps covering every segment),
  where JAX runs B1-B3, with the routes each side took counted; on a
  pyramid with host influence and on one without, where JAX computes the
  influence with B15 and the port with K15.
* The routing: the full-width split equals the JAX package's
  (``scripts/fused_conv_split.py``), the training route and
  ``serve_fused_conv=False`` keep K1 + matmul (+ K2), and the wrappers raise
  on what their kernels do not take.

Inputs are made with numpy from a seed; comparisons cover valid rows only.
"""

import collections
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3et_tpu_torch.data import pipeline as port_pipe
from se3et_tpu_torch.ops.kernels import windowed_conv as wc_k

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _neighbors(rng, b, nq, ns, h):
    """Random neighbour rows with sentinel (== ns) entries, incl. all-sentinel rows."""
    nbr = rng.randint(0, ns, size=(b, nq, h)).astype(np.int32)
    nbr[rng.rand(b, nq, h) < 0.3] = ns
    nbr[:, -3:] = ns
    return nbr


def _windows(nbr, ns):
    """Window maps of the port's build_window_maps over every source
    segment; asserts that no valid neighbour was dropped."""
    nseg = (ns + port_pipe.WINDOW_SSEG - 1) // port_pipe.WINDOW_SSEG
    maps = [port_pipe.build_window_maps(n, ns, nseg) for n in nbr]
    seg_idx = np.stack([m[0] for m in maps])
    local = np.stack([m[1] for m in maps])
    w = nseg * port_pipe.WINDOW_SSEG
    assert not ((local >= w) & (nbr < ns)).any(), "window maps dropped a neighbour"
    return jnp.asarray(seg_idx), jnp.asarray(local)


def _inputs(seed, b=2, ns=96, nq=70, h=9, k=15, ac=48, ac_out=96, ac2=192):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(b, ns, ac)).astype(np.float32)
    nbr = _neighbors(rng, b, nq, ns, h)
    infl = (rng.rand(b, nq, h, k) * (nbr < ns)[..., None]).astype(np.float32)
    rhs = (rng.normal(size=(k * ac, ac_out)) * (k * ac) ** -0.5).astype(np.float32)
    x2 = rng.normal(size=(b, ns, ac2)).astype(np.float32)
    return x, nbr, infl, rhs, x2


def _close(got, want, rtol):
    """Within rtol of the output scale: 1e-5 (float32 sums in another
    order), 1e-4 for the matmul forms, 0.03 in bf16 (the TPU kernels round
    other intermediates to bf16, as tests/test_windowed_conv.py states)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a)
            for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_wf_mm_plain_matches_windowed_kernel(dtype):
    """K12 plain == windowed_gather_wf_mm (interpret): (B, Nq, A*Cout) float32."""
    from se3et_tpu.ops.pallas import windowed_conv as wc

    jdt, tdt = _DTYPES[dtype]
    x, nbr, infl, rhs, _ = _inputs(0)
    seg_idx, local = _windows(nbr, x.shape[1])
    windows = wc.segment_window_gather(jnp.asarray(x, jdt), seg_idx)
    want = wc.windowed_gather_wf_mm(local, jnp.asarray(infl, jdt), windows,
                                    jnp.asarray(rhs, jdt), interpret=True)
    tx, tn, ti, tr = _torch([x, nbr, infl, rhs], tdt)
    got = wc_k.gather_wf_mm(tx, tn, ti, tr)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want, 1e-4 if dtype == "float32" else 0.03)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_wf_max_mm_plain_matches_windowed_kernel(dtype):
    """K13 plain == windowed_gather_wf_max_mm (interpret): the conv within
    tolerance, the skip max bit for bit (sentinels count as zero rows,
    all-sentinel rows give zeros)."""
    from se3et_tpu.ops.pallas import windowed_conv as wc

    jdt, tdt = _DTYPES[dtype]
    x, nbr, infl, rhs, x2 = _inputs(1, ac_out=48)
    seg_idx, local = _windows(nbr, x.shape[1])
    win = wc.segment_window_gather(jnp.asarray(x, jdt), seg_idx)
    win2 = wc.segment_window_gather(jnp.asarray(x2, jdt), seg_idx)
    want, want_pool = wc.windowed_gather_wf_max_mm(local, jnp.asarray(infl, jdt), win, win2,
                                                   jnp.asarray(rhs, jdt), interpret=True)
    tx, tn, ti, tr, t2 = _torch([x, nbr, infl, rhs, x2], tdt)
    got, pooled = wc_k.gather_wf_max_mm(tx, tn, ti, t2, tr)
    _close(got.numpy(), want, 1e-4 if dtype == "float32" else 0.03)
    assert pooled.dtype == tdt
    np.testing.assert_array_equal(pooled.float().numpy(), np.asarray(want_pool, np.float32))
    assert (pooled[:, -3:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_wf_max_plain_matches_windowed_kernel(dtype):
    """K14 plain == windowed_gather_wf_max (interpret): flat wf within
    tolerance, the skip max bit for bit."""
    from se3et_tpu.ops.pallas import windowed_conv as wc

    jdt, tdt = _DTYPES[dtype]
    x, nbr, infl, _, x2 = _inputs(2, ac2=384)
    seg_idx, local = _windows(nbr, x.shape[1])
    win = wc.segment_window_gather(jnp.asarray(x, jdt), seg_idx)
    win2 = wc.segment_window_gather(jnp.asarray(x2, jdt), seg_idx)
    want, want_pool = wc.windowed_gather_wf_max(local, jnp.asarray(infl, jdt), win, win2,
                                                interpret=True)
    tx, tn, ti, t2 = _torch([x, nbr, infl, x2], tdt)
    wf, pooled = wc_k.gather_wf_max(tx, tn, ti, t2)
    assert wf.dtype == tdt and wf.shape == want.shape
    _close(wf.float().numpy(), want, 1e-5 if dtype == "float32" else 0.03)
    np.testing.assert_array_equal(pooled.float().numpy(), np.asarray(want_pool, np.float32))


def test_wrappers_refuse_what_their_kernels_do_not_take():
    """No backward: an input that requires grad raises; widths outside the
    gates raise on the CPU as on the card (the model routes by the gates)."""
    x, nbr, infl, rhs, x2 = _torch(_inputs(3), torch.float32)
    with pytest.raises(ValueError, match="no backward"):
        wc_k.gather_wf_mm(x.requires_grad_(True), nbr, infl, rhs)
    x = x.detach()
    with pytest.raises(ValueError, match="no backward"):
        wc_k.gather_wf_max(x, nbr, infl, x2.requires_grad_(True))
    x2 = x2.detach()
    wide = torch.zeros((rhs.shape[0], wc_k.MM_MAX_AC_OUT + 8))
    assert not wc_k.gather_wf_mm_fits(x.shape[2], wide.shape[1], infl.shape[3])
    with pytest.raises(ValueError, match="does not take"):
        wc_k.gather_wf_mm(x, nbr, infl, wide)
    with pytest.raises(ValueError, match="does not take"):
        wc_k.gather_wf_max_mm(x, nbr, infl, x2, wide[:, :wc_k.MAX_MM_MAX_AC_OUT + 8])
    wide2 = torch.zeros((x.shape[0], x.shape[1], wc_k.MAX_SKIP_AC + 8))
    with pytest.raises(ValueError, match="does not take"):
        wc_k.gather_wf_max(x, nbr, infl, wide2)
    with pytest.raises(ValueError, match="bad weight shape"):
        wc_k.gather_wf_mm(x, nbr, infl, rhs[:-1])


def _load_split_script():
    spec = importlib.util.spec_from_file_location(
        "fused_conv_split", REPO / "scripts" / "fused_conv_split.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JAX_TO_PORT = {"B1": "K12", "B2": "K13", "B3": "K14", "B4": "K1", "B5": "K2",
                "matmul": "matmul"}


def test_full_width_split_matches_jax():
    """At full se3ete.3dmatch width (one synthetic pair, 20000 points, the
    registry's window settings) the port's gates send each conv to the
    counterpart of the JAX form: per pair K12 3, K13 1, K14 1, K1 5, K2 1."""
    rows = _load_split_script().split(20000)
    assert len(rows) == 10
    for name, jax_form, port_form in rows:
        assert [_JAX_TO_PORT[f] for f in jax_form.split(" + ")] == port_form.split(" + "), name
    counts = collections.Counter(f for _, _, p in rows for f in p.split(" + "))
    assert counts == {"K12": 3, "K13": 1, "K14": 1, "K1": 5, "K2": 1, "matmul": 6}


_ROUTES = ("gather_wf", "gather_wf_mm", "gather_wf_max_mm", "gather_wf_max", "neighbor_max",
           "influence")


@pytest.fixture
def route_calls(monkeypatch):
    """Calls the backbone makes to each conv wrapper (on the CPU the
    wrappers run their plain versions and count no kernel launch)."""
    from se3et_tpu_torch.nn import epn

    calls = collections.Counter()
    for name in _ROUTES:
        fn = getattr(epn, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(epn, name, spy)
    return calls


def _random_params(shapes, seed=0):
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


@pytest.mark.parametrize("host_influence", [True, False])
def test_backbone_fused_matches_jax_windowed_route(monkeypatch, route_calls, host_influence):
    """The port's backbone on its fused route (serve_fused_conv=True, the
    plain versions of K12-K14 on the CPU) == the JAX backbone on its
    windowed route (tiny config, window maps over every segment, no
    neighbour dropped), where JAX runs B1/B2/B3 in interpret mode; feats_f
    and feats_c on valid rows within 1e-4 of the output scale.  At these
    tiny widths JAX sends every strided block to B2 and the port every one
    to K13, so K14 is held against B3 by its own test only.  Without host
    influence JAX computes the weights of the 7 (stage, set) pairs with B15
    from its windows and the port with K15 (plain), 7 calls each; B15 reads
    the coordinates as double-bf16, which leaves up to 2e-4 in the weights
    (the JAX test of B15 holds it there), so that case is held at 1e-3 of
    the output scale (measured 4.5e-4)."""
    import __graft_entry__ as ge
    from se3et_tpu.data import pipeline as jpipe
    from se3et_tpu.nn.model import SE3ETModel as JaxModel
    from se3et_tpu.ops.pallas import windowed_conv as wc
    from se3et_tpu_torch.convert import load_flax_params
    from se3et_tpu_torch.nn.epn import EPNConfig
    from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors

    _, pipeline, jcfg = ge._flagship_configs(tiny=True)
    pipeline = dataclasses.replace(pipeline, patch_k=jcfg.num_points_in_patch,
                                   window_segments=1024)  # every segment
    jcfg = dataclasses.replace(jcfg, serve_fused_embedding=False)
    assert jcfg.serve_fused_conv
    jpipe.WINDOW_DROP_STATS.clear()
    data = ge._example_pair(pipeline, num_points=250, seed=0,
                            model_cfg=jcfg if host_influence else None)
    drops = {k: v for k, v in jpipe.WINDOW_DROP_STATS.items() if v[0]}
    assert not drops and jpipe.WINDOW_DROP_STATS, drops
    data = {k: (np.asarray(v, np.float32)
                if k.startswith("influence_") and k != "influence_sig" else v)
            for k, v in data.items()}

    b3_calls = []
    b3 = wc.windowed_gather_wf_max

    def count_b3(*args, **kwargs):
        b3_calls.append(1)
        return b3(*args, **kwargs)

    monkeypatch.setattr(wc, "windowed_gather_wf_max", count_b3)
    b15_calls = []
    b15 = wc.influence_windowed_pallas

    def count_b15(*args, **kwargs):
        b15_calls.append(1)
        return b15(*args, **kwargs)

    monkeypatch.setattr(wc, "influence_windowed_pallas", count_b15)
    jmodel = JaxModel(jcfg)
    rngs = {"params": jax.random.PRNGKey(0), "targets": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda d: jmodel.init(rngs, d, train=False, with_gt=False,
                                                  with_registration=False), data)
    params = _random_params(shapes)
    mm_before = len(wc.TRACE_MM_FLOPS)
    b3_calls.clear()
    b15_calls.clear()
    want = jax.tree.map(np.asarray, jax.jit(lambda p, d: jmodel.apply(
        p, d, train=False, with_gt=False, stop_after="backbone"))(params, data))
    jax_mm = len(wc.TRACE_MM_FLOPS) - mm_before

    fields = dataclasses.asdict(jcfg)
    fields["epn"] = EPNConfig(**fields["epn"])
    port = SE3ETModel(ModelConfig(**fields), device="cpu")
    load_flax_params(port, params)
    got = port(pyramid_to_tensors(data, "cpu"), stop_after="backbone")

    k15 = {} if host_influence else {"influence": 7}
    assert route_calls == {"gather_wf_mm": 7, "gather_wf_max_mm": 3, **k15}
    assert len(b15_calls) == route_calls["influence"]
    assert jax_mm == route_calls["gather_wf_mm"] + route_calls["gather_wf_max_mm"]
    assert len(b3_calls) == route_calls["gather_wf_max"] == 0
    m1, mc = data["masks_1"], data["masks_3"]
    tol = 1e-4 if host_influence else 1e-3
    for key, m in (("feats_f", m1), ("feats_c", mc)):
        g, w = got[key][torch.from_numpy(m)].numpy(), want[key][m]
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max())


@pytest.mark.parametrize("route", ["serve_fused_conv=False", "train"])
def test_unfused_routes_keep_k1_and_k2(route, route_calls):
    """serve_fused_conv=False and the training route run every gathering
    conv as K1 + matmul and every strided skip as K2 (training
    differentiates through them); the fused route runs none of them at
    the tiny widths."""
    from se3et_tpu_torch.data.pyramid import synthetic_pair
    from se3et_tpu_torch.experiments.configs import make_cfg, serving_config, tiny_config
    from se3et_tpu_torch.nn.model import SE3ETModel, pyramid_to_tensors

    cfg = tiny_config(serving_config(make_cfg("se3ete.3dmatch")))
    model_cfg = cfg.model
    if route != "train":
        model_cfg = dataclasses.replace(model_cfg, serve_fused_conv=False)
    data = pyramid_to_tensors(synthetic_pair(0, cfg.pipeline, model_cfg, 250, 2.0), "cpu")
    model = SE3ETModel(model_cfg, device="cpu")
    model(data, train=route == "train", stop_after="backbone")
    assert route_calls == {"gather_wf": 10, "neighbor_max": 3}
    route_calls.clear()
    if route == "train":
        model(data, stop_after="backbone")
        assert route_calls == {"gather_wf_mm": 7, "gather_wf_max_mm": 3}


@pytest.mark.parametrize("k,ac,ac_out", [(15, 192, 192), (3, 40, 16), (2, 8, 24)])
def test_mm_panels_lay_out_the_weight_as_the_kernel_reads_it(k, ac, ac_out):
    """The tensor-core K12's weight panels: panel (chunk c, kernel point k),
    row n holds rhs[k*AC + 32c + 8u + e, n] at unit u ^ ((n >> 1) & 3),
    element e, zero past AC."""
    rng = np.random.RandomState(k * ac)
    rhs = torch.from_numpy(rng.randn(k * ac, ac_out).astype(np.float32))
    panels = wc_k.mm_panels(rhs, k, ac).numpy()
    nch = -(-ac // 32)
    assert panels.shape == (nch, k, ac_out, 4, 8)
    want = np.zeros_like(panels)
    for c in range(nch):
        for kk in range(k):
            for n in range(ac_out):
                for u in range(4):
                    ch = 32 * c + 8 * u + np.arange(8)
                    ok = ch < ac
                    want[c, kk, n, u ^ ((n >> 1) & 3), ok] = rhs.numpy()[kk * ac + ch[ok], n]
    np.testing.assert_array_equal(panels, want)
