"""Which serving conv takes which fused kernel, JAX package against port.

    JAX_PLATFORMS=cpu python scripts/fused_conv_split.py [--num-points 20000]

Builds pair 0 of the synthetic generator (seed 7351, extent 2.0, the
``se3ete.3dmatch`` serving cell) with the JAX package's numpy pipeline and
the registry's window settings, reads off each conv's window width W and
neighbour count H, and evaluates the JAX package's VMEM gates
(``windowed_wf_mm_fits``, ``windowed_wf_max_fits``,
``windowed_wf_max_mm_fits``, ``windowed_max_pool_fits``; arithmetic only,
no model is traced) with the arguments ``se3et_tpu/nn/epn.py`` passes them
at full width.  Beside each, the port's gates
(``gather_wf_mm_fits`` / ``gather_wf_max_mm_fits``) on the same widths.
Prints one line per gathering conv and the launch counts per served pair.
"""

import argparse
import collections
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from se3et_tpu.data.datasets import SyntheticPairDataset
from se3et_tpu.data.pipeline import build_pair_pyramid
from se3et_tpu.experiments import make_cfg
from se3et_tpu.ops.pallas import windowed_conv as wc
from se3et_tpu_torch.ops.kernels import windowed_conv as port


def split(num_points=20000, verbose=False):
    """[(conv, JAX form, port form)] for each gathering conv of one served
    pair, forms as "B1", "B4 + matmul + B5", "K12", "K1 + matmul + K2"..."""
    cfg = make_cfg("se3ete.3dmatch")
    m, pcfg = cfg.model, cfg.pipeline
    k, a = m.epn.num_kernel_points, m.epn.kanchor
    min_ac = m.epn.wf_kfirst_min_ac
    item = SyntheticPairDataset(num_pairs=1, num_points=num_points, seed=cfg.seed,
                                extent=2.0)[0]
    data = build_pair_pyramid(item["ref_points"], item["src_points"], item["transform"],
                              pcfg)

    def window(set_name, st):
        segs, local = data[f"{set_name}_segs_{st}"], data[f"{set_name}_local_{st}"]
        sseg = data[f"{set_name}_wsseg_{st}"].shape[-1]
        return segs.shape[2] * sseg, local.shape[2], local.shape[1]

    rows = []

    def conv(name, set_name, st, cin, cout, ac2=None):
        w, h, nq = window(set_name, st)
        ac, ac_out = a * cin, a * cout
        kfirst = m.epn.wf_kfirst or 0 < min_ac <= ac
        if ac2 is None:
            fits = cin < 256 and wc.windowed_wf_mm_fits(w, ac, ac_out, h, k, kfirst)
            jax = "B1" if fits else "B4 + matmul"
            mine = ("K12" if cin < 256 and port.gather_wf_mm_fits(ac, ac_out, k)
                    else "K1 + matmul")
        elif wc.windowed_wf_max_fits(w, ac, ac2, h, k, kfirst):
            fits = cin < 256 and wc.windowed_wf_max_mm_fits(w, ac, ac2, ac_out, h, k, kfirst)
            jax = "B2" if fits else "B3 + matmul"
        else:
            conv_fits = cin < 256 and wc.windowed_wf_mm_fits(w, ac, ac_out, h, k, kfirst)
            pool = "B5" if wc.windowed_max_pool_fits(w, ac2) else "XLA max"
            jax = ("B1" if conv_fits else "B4 + matmul") + " + " + pool
        if ac2 is not None:
            if cin < 256 and port.gather_wf_max_mm_fits(ac, ac_out, ac2, k):
                mine = "K13"
            elif port.gather_wf_max_fits(ac2, k):
                mine = "K14 + matmul"
            else:
                conv_k12 = cin < 256 and port.gather_wf_mm_fits(ac, ac_out, k)
                mine = ("K12" if conv_k12 else "K1 + matmul") + " + K2"
        rows.append((name, jax, mine))
        if verbose:
            skip = f" AC2={ac2}" if ac2 else ""
            print(f"{name:28s} {set_name}_{st}: Nq={nq} H={h} W={w} AC={ac} "
                  f"A*Cout={ac_out}{skip} kfirst={kfirst}: JAX {jax}; port {mine}")

    d = m.init_dim
    conv("stage 0 bottleneck", "neighbors", 0, d // 2, d // 2)
    in_dim = 2 * d
    for st in range(1, m.num_stages):
        mid = in_dim // 4
        conv(f"stage {st} strided bottleneck", "subsampling", st - 1, mid, mid,
             ac2=a * in_dim)
        conv(f"stage {st} bottleneck 1", "neighbors", st, in_dim // 2, in_dim // 2)
        conv(f"stage {st} bottleneck 2", "neighbors", st, in_dim // 2, in_dim // 2)
        in_dim *= 2
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-points", type=int, default=20000)
    rows = split(ap.parse_args().num_points, verbose=True)
    count = lambda i: collections.Counter(f for r in rows for f in r[i].split(" + "))  # noqa: E731
    print(f"per served pair: JAX {dict(count(1))}; port {dict(count(2))}")


if __name__ == "__main__":
    main()
