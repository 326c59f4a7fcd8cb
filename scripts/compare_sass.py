"""This checkout's compiled kernels against another checkout's, kernel by
kernel: is the SASS the same?

    python scripts/compare_sass.py --other TREE [SOURCE ...]   # where nvcc is

Builds ``se3et_tpu_torch/csrc/<SOURCE>.cu`` of both checkouts (by default
``rpe_attention`` and ``rpe_attention_femb``, the two files that include
``rpe_attention_ws.cuh``) with the flags of ``ops/kernels/_build.py``
into ``se3et_tpu_torch/_build/sass/``, disassembles each library with
``cuobjdump -sass`` and prints, per kernel (mangled name, its anonymous
namespace's per-build hash left out), whether its SASS text is the
other's, differs (with the count of differing lines and of instructions
on each side), or exists on one side only.  Exits non-zero
where a kernel present in both differs.  A change meant to leave one
width's instances as they were (a plan added for another width) is held
to it this way: ptxas may schedule the same source expressions
differently, and the same bits can run slower (K11 at head width 64, 9 %).
"""

import argparse
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3et_tpu_torch.ops.kernels import _build  # noqa: E402

DEFAULT_SOURCES = ("rpe_attention", "rpe_attention_femb")


def _sass(tree, source, out_dir, tag):
    """{kernel: [SASS lines]} of ``source`` compiled from checkout ``tree``."""
    lib = os.path.join(out_dir, f"{tag}_{source}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(tree, "se3et_tpu_torch", "csrc", f"{source}.cu")],
                   check=True)
    dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
                           "-sass", lib], check=True, capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:  # an anonymous namespace's name carries a hash of the build
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
            kernels[name] = []
        elif name is not None and line.strip():
            kernels[name].append(line.strip())
    return kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("sources", nargs="*", default=DEFAULT_SOURCES)
    args = parser.parse_args()
    out_dir = os.path.join(_build.BUILD_DIR, "sass")
    os.makedirs(out_dir, exist_ok=True)
    differ = 0
    for source in args.sources:
        mine = _sass(REPO, source, out_dir, "this")
        theirs = _sass(os.path.abspath(args.other), source, out_dir, "other")
        same = sorted(k for k in mine if k in theirs and mine[k] == theirs[k])
        print(f"{source}.cu: {len(same)} kernels with the other's SASS", flush=True)
        for k in sorted(set(mine) | set(theirs)):
            if k in same:
                print(f"  same: {k}")
            elif k not in theirs:
                print(f"  this checkout only: {k} ({len(mine[k])} lines)")
            elif k not in mine:
                print(f"  the other only: {k} ({len(theirs[k])} lines)")
            else:
                n = sum(a != b for a, b in zip(mine[k], theirs[k])) \
                    + abs(len(mine[k]) - len(theirs[k]))
                print(f"  DIFFERS: {k} ({n} lines; {len(mine[k])} here, {len(theirs[k])} "
                      f"there)")
                differ += 1
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
