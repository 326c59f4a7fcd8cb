"""The PyTorch port's copies of the JAX package's numpy modules equal the
originals on seeded inputs: anchor tables, kernel-point dispositions, real
spherical harmonics and Wigner-D blocks, and one synthetic pyramid pair,
array for array.  (The port may import nothing of the JAX package, so it
keeps its own copies; these tests keep them true.)
"""

import dataclasses

import numpy as np
import pytest

from se3et_tpu.core import anchors as j_anchors
from se3et_tpu.core import harmonics as j_harmonics
from se3et_tpu.core import kernel_points as j_kp
from se3et_tpu.data import datasets as j_datasets
from se3et_tpu.data import pipeline as j_pipeline
from se3et_tpu_torch.core import anchors, harmonics
from se3et_tpu_torch.core import kernel_points as kp
from se3et_tpu_torch.data import datasets, pipeline


@pytest.mark.parametrize("kanchor,quotient", [(1, 1), (3, 1), (4, 3), (6, 4), (12, 5)])
def test_anchor_space_matches(kanchor, quotient):
    want = j_anchors.get_anchor_space(kanchor, quotient)
    got = anchors.get_anchor_space(kanchor, quotient)
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if w is None:
            assert g is None, field.name
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=field.name)


@pytest.mark.parametrize("name", ["k_015_center_3D", "k_lloyd_045_center_3D",
                                  "k_lloyd_045_verticals_3D"])
def test_load_kernels_dispositions_match(name):
    """The three committed dispositions load to the same kernel points."""
    num = int(name.split("_")[-3])
    fixed = name.split("_")[-2]
    want = j_kp.load_kernels(1.0, num, dimension=3, fixed=fixed, seed=3)
    got = kp.load_kernels(1.0, num, dimension=3, fixed=fixed, seed=3)
    np.testing.assert_array_equal(got, want)


def test_equivariant_kernel_tables_match():
    want = j_kp.equivariant_kernel_points(0.0625, 15, 6, 4)
    got = kp.equivariant_kernel_points(0.0625, 15, 6, 4)
    np.testing.assert_array_equal(got, want)
    space, j_space = anchors.get_anchor_space(6, 4), j_anchors.get_anchor_space(6, 4)
    for g, w in zip(kp.kernel_permutation_tables(got, space),
                    j_kp.kernel_permutation_tables(want, j_space)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_harmonics_match():
    rng = np.random.RandomState(0)
    vec = rng.normal(size=(50, 3))
    np.testing.assert_array_equal(harmonics.real_sh([0, 1, 2], vec),
                                  j_harmonics.real_sh([0, 1, 2], vec))
    anc = j_anchors.get_anchor_space(6, 4).anchors
    for g, w in zip(harmonics.anchor_wigner_d([0, 1, 2], anc),
                    j_harmonics.anchor_wigner_d([0, 1, 2], anc)):
        np.testing.assert_array_equal(g, w)


def test_synthetic_pair_pyramid_matches():
    """SyntheticPairDataset seed 0 -> build_pair_pyramid: the same dict."""
    cfg = j_pipeline.PyramidConfig(
        num_stages=4, voxel_size=0.14, search_radius=0.35, neighbor_limits=(8, 8, 8, 8),
        stage_caps=(128, 64, 32, 24), coarse_point_cap=24, window_segments=0, patch_k=8)
    port_cfg = pipeline.PyramidConfig(**{f.name: getattr(cfg, f.name)
                                         for f in dataclasses.fields(cfg)})
    want_item = j_datasets.SyntheticPairDataset(num_pairs=1, num_points=400, seed=0)[0]
    got_item = datasets.SyntheticPairDataset(num_pairs=1, num_points=400, seed=0)[0]
    for key in ("ref_points", "src_points", "transform"):
        np.testing.assert_array_equal(got_item[key], want_item[key])
    want = j_pipeline.build_pair_pyramid(want_item["ref_points"], want_item["src_points"],
                                         want_item["transform"], cfg)
    got = pipeline.build_pair_pyramid(got_item["ref_points"], got_item["src_points"],
                                      got_item["transform"], port_cfg)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
