r"""Fixed-shape point-pyramid construction for TPU consumption.

This is the TPU-native counterpart of the reference's stack-mode collate
(``geotransformer/utils/data.py:13-97``).  Differences by design:

* **Separate ref/src cloud axis.**  The reference concatenates both clouds and
  threads a ``lengths`` vector through every op (requiring ``.item()`` host
  syncs in the model, ``model.py:86-98``).  We emit arrays with a leading cloud
  axis of size 2 (0 = ref, 1 = src) and boolean validity masks — the jitted
  model never touches a dynamic length.

* **Static shape buckets.**  Every stage is padded to a configured cap; the
  neighbor matrices have calibrated fixed widths (the reference computes the
  same widths via ``calibrate_neighbors_stack_mode``, ``utils/data.py:212-252``
  — its own static-shape mechanism, which we keep).

* **Local sentinel indices.**  Neighbor indices are per-cloud with sentinel
  ``N_stage`` (the reference uses global stacked indices with a global
  sentinel).

The emitted dict (all numpy, ready for ``jnp.asarray``):

========================  =====================================================
key                       shape
========================  =====================================================
``points_{s}``            (2, N_s, 3) float32, zero-padded
``masks_{s}``             (2, N_s) bool
``neighbors_{s}``         (2, N_s, K_s) int32, sentinel N_s
``subsampling_{s}``       (2, N_{s+1}, K_s) int32 (queries at s+1, support s)
``upsampling_{s}``        (2, N_s, K_{s+1}) int32 (queries at s, support s+1)
``normals_{s}``           (2, N_s, 3) float32 (only if use_normals)
``features``              (2, N_0, C_in) float32
``transform``             (4, 4) float32 (src -> ref ground truth)
========================  =====================================================
"""

from __future__ import annotations

import dataclasses

import numpy as np

from se3et_tpu_torch.data import host_ops


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    num_stages: int = 4
    voxel_size: float = 0.025  # first-stage voxel (stage 0 input is pre-sampled)
    search_radius: float = 0.0625  # init_radius = 2.5 * voxel_size
    neighbor_limits: tuple[int, ...] = (38, 36, 36, 38)
    stage_caps: tuple[int, ...] = (16384, 4096, 1536, 1024)
    coarse_point_cap: int = 2000  # hard cap on the coarsest stage (utils/data.py:35-43)
    input_dim: int = 1
    use_normals: bool = False
    # segments (of WINDOW_SSEG=16 source rows) per query-block window for the
    # fused conv gather; 0 disables the window maps.  Window maps (segment
    # lists + window-local neighbor indices) are emitted for EVERY conv
    # neighbor set — same-level ``neighbors_{s}`` and strided
    # ``subsampling_{s}`` — so the whole backbone runs gather-free.  Morton
    # ordering keeps per-block segment occupancy low; overflow drops are
    # counted in :data:`WINDOW_DROP_STATS`.
    window_segments: int = 56
    # per-set overrides: ((set_key, nseg), ...) — kernel cost scales with the
    # window width, and the drop-rate/width tradeoff differs per set (coarser
    # stages spread neighbors over more Morton segments).  Set from measured
    # drop rates; keys are f"neighbors_{s}" / f"subsampling_{s}".
    window_segments_by_set: tuple = ()
    # per-set SEGMENT GRANULARITY overrides: ((set_key, sseg), ...), default
    # :data:`WINDOW_SSEG`.  Finer segments capture Morton-local neighbors
    # with fewer wasted rows (kernel cost is linear in W = nseg * sseg) but
    # need more segment slots (segment-gather matmul cost is linear in
    # nseg); scripts/sweep_sseg.py picks the per-set winner host-side.
    # Round-5 sweep: 8-row segments cut W 25-33% on the stage-0 sets only;
    # every other set ties at the same W with 2x the slots -> stays 16.
    # The chosen sseg is shipped to the model as a zero-cost shape-carrier
    # array (f"{set}_wsseg_{s}", shape (sseg,)) — self-describing data, no
    # config-sync hazard between pipeline and model.
    window_sseg_by_set: tuple = ()
    # patch size for the host-side point-to-node partition (stage 1 points to
    # coarsest-stage nodes); 0 disables the precompute and the model falls
    # back to the device op.  Set to the model's num_points_in_patch.
    patch_k: int = 0
    # per-set neighbor-count caps: ((set_key, H), ...).  Conv/maxpool kernel
    # cost is linear in the padded H, but the calibrated neighbor_limits are
    # tail-quantile worst cases (measured 3DMatch-scale means: 6-27 valid of
    # 36-38 columns).  Neighbors are distance-sorted, so truncating the (also
    # sentinel-compacted) rows keeps the NEAREST = highest-influence entries;
    # dropped-influence mass per set is calibrated <= 0.5%
    # (scripts/calibrate_h_caps.py) and counted in :data:`H_DROP_STATS`.
    neighbor_h_caps_by_set: tuple = ()

    def nseg_for(self, set_key: str, cap_s: int) -> int:
        nseg = dict(self.window_segments_by_set).get(set_key, self.window_segments)
        sseg = self.sseg_for(set_key)
        return min(nseg, (cap_s + sseg - 1) // sseg)

    def sseg_for(self, set_key: str) -> int:
        return dict(self.window_sseg_by_set).get(set_key, WINDOW_SSEG)

    def h_cap_for(self, set_key: str) -> int:
        return dict(self.neighbor_h_caps_by_set).get(set_key, 0)

    def __post_init__(self):
        assert len(self.neighbor_limits) == self.num_stages
        assert len(self.stage_caps) == self.num_stages


# cap-bind accounting: {f"stage_{s}": [times_bound, clouds_seen]}
CAP_BIND_STATS: dict[str, list[int]] = {}


def _cap_select(n: int, cap: int, seed: int) -> np.ndarray:
    """Deterministic uniform subsample of ``cap`` of ``n`` indices, sorted to
    preserve the Morton order.  Replaces prefix truncation, which dropped an
    entire spatial corner whenever a cap bound (the reference random-subsamples,
    ``threedmatch/dataset.py:77-81``)."""
    rng = np.random.RandomState(seed % (2**31 - 1))
    return np.sort(rng.permutation(n)[:cap])


def _pad_points(points: np.ndarray, cap: int):
    # caps are enforced (unbiased) in build_cloud_pyramid before neighbor
    # construction; the prefix guard here is a safety net only
    n = points.shape[0]
    if n > cap:
        points = points[:cap]
        n = cap
    out = np.zeros((cap,) + points.shape[1:], dtype=points.dtype)
    out[:n] = points
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    return out, mask, n


def _pad_neighbors(idx: np.ndarray, num_valid_q: int, cap_q: int, cap_s: int, old_sentinel: int):
    """Remap a (n_q, K) local neighbor matrix into the padded index space."""
    k = idx.shape[1]
    out = np.full((cap_q, k), cap_s, dtype=np.int32)
    idx = idx[:num_valid_q].astype(np.int32)
    idx = np.where((idx >= old_sentinel) | (idx >= cap_s), cap_s, idx)
    out[:num_valid_q] = idx
    return out


def build_cloud_pyramid(
    points: np.ndarray, cfg: PyramidConfig, normals: np.ndarray | None = None
):
    """Multi-stage voxel pyramid + neighbor/pool/unpool indices for ONE cloud.

    Mirrors ``precompute_data_stack_mode`` (``utils/data.py:13-97``) with the
    coarsest-stage point cap and the same radius doubling schedule.
    """
    voxel = cfg.voxel_size
    stage_points, stage_normals = [], []
    cur_p, cur_n = np.asarray(points, np.float32), normals
    for s in range(cfg.num_stages):
        if s > 0:
            cur_p, cur_n = host_ops.grid_subsample_single(cur_p, voxel, cur_n)
        # enforce the static stage cap HERE, before neighbor construction —
        # uniform random subsample (unbiased; prefix truncation of a
        # Morton-sorted cloud would drop a whole spatial corner), with
        # bind-rate accounting for cap tuning
        cap = cfg.stage_caps[s]
        if s == cfg.num_stages - 1:
            cap = min(cap, cfg.coarse_point_cap)
        agg = CAP_BIND_STATS.setdefault(f"stage_{s}", [0, 0])
        agg[0] += int(cur_p.shape[0] > cap)
        agg[1] += 1
        if cur_p.shape[0] > cap:
            sel = _cap_select(cur_p.shape[0], cap, seed=s * 7919 + cur_p.shape[0])
            cur_p = cur_p[sel]
            if cur_n is not None:
                cur_n = cur_n[sel]
        # Morton-sort each stage: device-side neighbor gathers become
        # spatially local (pure reordering; all index matrices are built
        # afterwards against the sorted points)
        order = host_ops.morton_order(cur_p)
        cur_p = cur_p[order]
        if cur_n is not None:
            cur_n = cur_n[order]
        stage_points.append(cur_p)
        stage_normals.append(cur_n)
        voxel *= 2.0

    radius = cfg.search_radius
    neighbors, subsampling, upsampling = [], [], []
    for s in range(cfg.num_stages):
        neighbors.append(
            host_ops.radius_search_single(
                stage_points[s], stage_points[s], radius, cfg.neighbor_limits[s]
            )
        )
        if s < cfg.num_stages - 1:
            subsampling.append(
                host_ops.radius_search_single(
                    stage_points[s + 1], stage_points[s], radius, cfg.neighbor_limits[s]
                )
            )
            upsampling.append(
                host_ops.radius_search_single(
                    stage_points[s], stage_points[s + 1], radius * 2.0,
                    cfg.neighbor_limits[s + 1],
                )
            )
        radius *= 2.0
    return stage_points, stage_normals, neighbors, subsampling, upsampling


# Query rows per window block (kernel grid granularity).  Smaller blocks
# see fewer source segments: 128 -> 64 cuts summed window width W (= kernel
# cost) another ~24% at matched drops (measured host-side, round 3) for 2x
# grid programs — the W term dominates.
WINDOW_QSEG = 64
# Source rows per window segment.  Finer than the query block: halving the
# segment size from 128 cut the summed window width W (= kernel cost, linear
# in W) by ~25-35% at matched drop rates, and 64 -> 32 a further ~15-20% —
# neighbors of a 128-query Morton block concentrate in short runs of the
# Morton-sorted source stage, so finer segments capture them with fewer
# wasted rows.  Keep per-set budgets multiples of (128 // WINDOW_SSEG) so W
# stays on a 128-lane boundary inside the kernels.
WINDOW_SSEG = 16

# aggregate window-overflow accounting: {stage_key: [dropped, total]}
WINDOW_DROP_STATS: dict[str, list[int]] = {}

# aggregate neighbor-H-cap accounting: {set_key: [dropped_valid, total_valid]}
H_DROP_STATS: dict[str, list[int]] = {}


def _cap_neighbor_h(arr: np.ndarray, hcap: int, sentinel: int,
                    stats_key: str) -> np.ndarray:
    """Truncate a padded (Nq, H) neighbor matrix to ``hcap`` columns.

    Rows are first sentinel-compacted (valid entries pushed left, stable) so
    the cut drops only real overflow, never a valid entry shadowed by a
    stage-cap-remapped sentinel.  Order within valid entries is preserved
    (distance-sorted by the radius search), so the dropped entries are the
    FARTHEST neighbors — the minimum-influence ones under every supported
    influence mode.  Semantically position-independent for all consumers
    (conv sum, maxpool, window maps).
    """
    if hcap <= 0 or hcap >= arr.shape[1]:
        return arr
    valid = arr < sentinel
    order = np.argsort(~valid, axis=1, kind="stable")
    arr = np.take_along_axis(arr, order, axis=1)
    dropped = int((arr[:, hcap:] < sentinel).sum())
    st = H_DROP_STATS.setdefault(stats_key, [0, 0])
    st[0] += dropped
    st[1] += int(valid.sum())
    return arr[:, :hcap]


def build_window_maps(
    neighbors: np.ndarray,
    cap_s: int,
    max_segs: int,
    stats_key: str | None = None,
    sseg: int | None = None,
):
    """Segment-window maps for the fused TPU conv gather.

    For each block of ``WINDOW_QSEG`` query rows of a padded ``(cap_q, H)``
    neighbor matrix (sentinel ``cap_s``), pick the ``max_segs`` source
    segments (of ``sseg`` rows each, default :data:`WINDOW_SSEG`) covering
    the most neighbors, and remap neighbor indices to window-local positions
    ``slot * sseg + (idx % sseg)``; neighbors outside the chosen segments
    (rare at calibrated budgets) and sentinels map to ``max_segs * sseg``
    (masked).

    Returns ``(seg_idx (nblk_q, max_segs) int32, local (cap_q, H) int32)``.
    Overflow drops are accumulated in :data:`WINDOW_DROP_STATS`.
    """
    qseg = WINDOW_QSEG
    if sseg is None:
        sseg = WINDOW_SSEG
    cap_q, h = neighbors.shape
    nblk_q = (cap_q + qseg - 1) // qseg
    nblk_s = (cap_s + sseg - 1) // sseg
    # more slots than source segments exist is full coverage — clamp (a
    # larger max_segs would make the slot bookkeeping index out of range)
    max_segs = min(max_segs, nblk_s)
    w = max_segs * sseg
    pad_q = nblk_q * qseg - cap_q
    nb = neighbors
    if pad_q:
        nb = np.pad(nb, ((0, pad_q), (0, 0)), constant_values=cap_s)
    valid = nb < cap_s  # (nblk_q*qseg, h)
    total = int(valid.sum())
    blk_id = np.repeat(np.arange(nblk_q), qseg)[:, None]
    seg_of = np.where(valid, nb // sseg, 0)
    # per-(block, segment) neighbor counts in one bincount
    codes = (blk_id * nblk_s + seg_of)[valid]
    counts2d = np.bincount(codes, minlength=nblk_q * nblk_s).reshape(
        nblk_q, nblk_s
    )
    # top-max_segs segments per block, count-descending, then ascending ids
    top = np.argsort(-counts2d, axis=1, kind="stable")[:, :max_segs]
    top_counts = np.take_along_axis(counts2d, top, axis=1)
    kept = top_counts > 0
    # ascending segment order within the kept slots (empty slots -> 0)
    key = np.where(kept, top, nblk_s)
    order = np.argsort(key, axis=1, kind="stable")
    uniq = np.take_along_axis(top, order, axis=1)
    kept = np.take_along_axis(kept, order, axis=1)
    seg_idx = np.where(kept, uniq, 0).astype(np.int32)
    dropped = total - int(top_counts.sum())

    slot_of = np.full((nblk_q, nblk_s), -1, np.int64)
    rows = np.repeat(np.arange(nblk_q), max_segs)[kept.reshape(-1)]
    slots = np.tile(np.arange(max_segs), nblk_q)[kept.reshape(-1)]
    slot_of[rows, uniq.reshape(-1)[kept.reshape(-1)]] = slots
    slot = np.where(valid, slot_of[blk_id, seg_of], -1)
    local = np.where(slot >= 0, slot * sseg + nb % sseg, w).astype(np.int32)
    local = local[:cap_q]
    if stats_key is not None:
        agg = WINDOW_DROP_STATS.setdefault(stats_key, [0, 0])
        agg[0] += dropped
        agg[1] += total
    return seg_idx, local


def build_pair_pyramid(
    ref_points: np.ndarray,
    src_points: np.ndarray,
    transform: np.ndarray,
    cfg: PyramidConfig,
    ref_feats: np.ndarray | None = None,
    src_feats: np.ndarray | None = None,
) -> dict:
    """Build the padded two-cloud pyramid dict for a registration pair."""
    out: dict[str, np.ndarray] = {}
    clouds = []
    for pts in (ref_points, src_points):
        normals = host_ops.estimate_normals(pts) if cfg.use_normals else None
        clouds.append(build_cloud_pyramid(pts, cfg, normals))

    valid_counts = [[0, 0] for _ in range(cfg.num_stages)]
    for s in range(cfg.num_stages):
        cap = cfg.stage_caps[s]
        pts_list, mask_list, nrm_list = [], [], []
        for c in range(2):
            stage_points, stage_normals = clouds[c][0], clouds[c][1]
            p, m, n_valid = _pad_points(stage_points[s], cap)
            valid_counts[s][c] = n_valid
            pts_list.append(p)
            mask_list.append(m)
            if cfg.use_normals:
                nrm, _, _ = _pad_points(stage_normals[s], cap)
                nrm_list.append(nrm)
        out[f"points_{s}"] = np.stack(pts_list, 0)
        out[f"masks_{s}"] = np.stack(mask_list, 0)
        if cfg.use_normals:
            out[f"normals_{s}"] = np.stack(nrm_list, 0)

    for s in range(cfg.num_stages):
        cap_s = cfg.stage_caps[s]
        nb = []
        for c in range(2):
            raw = clouds[c][2][s]
            old_sentinel = clouds[c][0][s].shape[0]
            padded = _pad_neighbors(
                raw, min(valid_counts[s][c], cap_s), cap_s, cap_s, old_sentinel
            )
            nb.append(
                _cap_neighbor_h(
                    padded, cfg.h_cap_for(f"neighbors_{s}"), cap_s,
                    f"neighbors_{s}",
                )
            )
        out[f"neighbors_{s}"] = np.stack(nb, 0)
        if cfg.window_segments > 0:
            nseg = cfg.nseg_for(f"neighbors_{s}", cap_s)
            sseg = cfg.sseg_for(f"neighbors_{s}")
            maps = [
                build_window_maps(nb[c], cap_s, nseg,
                                  stats_key=f"neighbors_{s}", sseg=sseg)
                for c in range(2)
            ]
            out[f"neighbors_segs_{s}"] = np.stack([m[0] for m in maps], 0)
            out[f"neighbors_local_{s}"] = np.stack([m[1] for m in maps], 0)
            # zero-cost shape carrier: the consumer reads sseg off the shape
            out[f"neighbors_wsseg_{s}"] = np.zeros(sseg, np.int8)
        if s < cfg.num_stages - 1:
            cap_q = cfg.stage_caps[s + 1]
            sub, up = [], []
            for c in range(2):
                raw_sub = clouds[c][3][s]
                raw_up = clouds[c][4][s]
                sent_s = clouds[c][0][s].shape[0]
                sent_s1 = clouds[c][0][s + 1].shape[0]
                sub.append(
                    _cap_neighbor_h(
                        _pad_neighbors(
                            raw_sub, min(valid_counts[s + 1][c], cap_q),
                            cap_q, cap_s, sent_s,
                        ),
                        cfg.h_cap_for(f"subsampling_{s}"), cap_s,
                        f"subsampling_{s}",
                    )
                )
                up.append(
                    _pad_neighbors(
                        raw_up, min(valid_counts[s][c], cap_s), cap_s, cap_q, sent_s1
                    )
                )
            out[f"subsampling_{s}"] = np.stack(sub, 0)
            out[f"upsampling_{s}"] = np.stack(up, 0)
            if cfg.window_segments > 0:
                nseg = cfg.nseg_for(f"subsampling_{s}", cap_s)
                sseg = cfg.sseg_for(f"subsampling_{s}")
                maps = [
                    build_window_maps(
                        sub[c], cap_s, nseg, stats_key=f"subsampling_{s}",
                        sseg=sseg,
                    )
                    for c in range(2)
                ]
                out[f"subsampling_segs_{s}"] = np.stack([m[0] for m in maps], 0)
                out[f"subsampling_local_{s}"] = np.stack([m[1] for m in maps], 0)
                out[f"subsampling_wsseg_{s}"] = np.zeros(sseg, np.int8)

    if cfg.patch_k > 0 and cfg.num_stages >= 2:
        fine, coarse = 1, cfg.num_stages - 1
        cap_f = cfg.stage_caps[fine]
        cap_c_pad = cfg.stage_caps[coarse]
        p2n_list, nm_list, ki_list, km_list = [], [], [], []
        for c in range(2):
            pts_f = clouds[c][0][fine]
            pts_c = clouds[c][0][coarse]
            p2n, nm, ki, km = host_ops.point_to_node_partition_host(
                pts_f, pts_c, cfg.patch_k, cell_hint=cfg.voxel_size * 4
            )
            n_f, n_c = pts_f.shape[0], pts_c.shape[0]
            p2n_pad = np.full(cap_f, cap_c_pad, np.int32)
            p2n_pad[:n_f] = p2n
            nm_pad = np.zeros(cap_c_pad, bool)
            nm_pad[:n_c] = nm
            ki_pad = np.full((cap_c_pad, cfg.patch_k), cap_f, np.int32)
            ki_pad[:n_c] = np.where(ki[:n_c] >= n_f, cap_f, ki[:n_c])
            km_pad = np.zeros((cap_c_pad, cfg.patch_k), bool)
            km_pad[:n_c] = km[:n_c]
            p2n_list.append(p2n_pad)
            nm_list.append(nm_pad)
            ki_list.append(ki_pad)
            km_list.append(km_pad)
        out["point_to_node"] = np.stack(p2n_list, 0)
        out["patch_node_masks"] = np.stack(nm_list, 0)
        out["node_knn_indices"] = np.stack(ki_list, 0)
        out["node_knn_masks"] = np.stack(km_list, 0)

    cap0 = cfg.stage_caps[0]
    feats = np.zeros((2, cap0, cfg.input_dim), np.float32)
    for c, f in enumerate((ref_feats, src_feats)):
        n = valid_counts[0][c]
        if f is None:
            feats[c, :n] = 1.0  # reference uses all-ones input features
        else:
            feats[c, :n] = f[:cap0]
    out["features"] = feats
    out["transform"] = np.asarray(transform, np.float32)
    return out


def calibrate_neighbor_limits(
    sample_pairs,
    cfg: PyramidConfig,
    keep_ratio: float = 0.8,
    sample_threshold: int = 2000,
) -> tuple[int, ...]:
    """Pick per-stage neighbor widths covering ``keep_ratio`` of points.

    Port of ``calibrate_neighbors_stack_mode`` (``utils/data.py:212-252``):
    run the pyramid over samples with a generous width, histogram neighbor
    counts, choose the width whose CDF reaches ``keep_ratio``.

    Args:
        sample_pairs: iterable of (ref_points, src_points) numpy arrays.
    """
    hist_n = int(np.ceil(4.0 / 3.0 * np.pi * (cfg.search_radius / cfg.voxel_size + 1) ** 3))
    wide = dataclasses.replace(cfg, neighbor_limits=(hist_n,) * cfg.num_stages)
    hists = np.zeros((cfg.num_stages, hist_n), dtype=np.int64)
    for ref_points, src_points in sample_pairs:
        for pts in (ref_points, src_points):
            stage_points, _, neighbors, _, _ = build_cloud_pyramid(pts, wide)
            for s in range(cfg.num_stages):
                sentinel = stage_points[s].shape[0]
                counts = np.sum(neighbors[s] < sentinel, axis=1)
                hists[s] += np.bincount(counts, minlength=hist_n)[:hist_n]
        if hists.sum(axis=1).min() > sample_threshold:
            break
    cum = np.cumsum(hists.T, axis=0)
    limits = np.sum(cum < keep_ratio * cum[-1], axis=0)
    return tuple(int(x) for x in np.maximum(limits, 1))
