"""Compare the machine code of this tree's CUDA kernels with another tree's.

    python3 -m slak_tpu_torch.tools.sass_diff BASE_DIR [mlp dwconv ...]

BASE_DIR is another checkout of the repository (e.g. a ``git archive`` of
an earlier commit). For each named source under
``slak_tpu_torch/ops/csrc/`` (default: every source of the base tree) it
builds both trees' file to a cubin with nvcc (the flags of
``ops/_build.py``), lists
each kernel's SASS with ``cuobjdump -sass``, and prints, for every kernel
of the base tree, its instruction count and whether this tree has a
kernel with the same instructions, or the same up to the offsets of the
kernel parameters in the constant bank (a parameter struct that gained a
field). Kernels are matched by their code, not their names, which change
with template arguments. Needs nvcc and cuobjdump, no card. The cubins
and SASS listings go to ``slak_tpu_torch/_build/sass/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

from slak_tpu_torch.ops import _build

OUT_DIR = os.path.join(_build.BUILD_DIR, "sass")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def _tool(name: str) -> str:
    path = os.path.join(os.path.dirname(_build._nvcc()), name)
    if not os.path.exists(path):
        path = shutil.which(name) or ""
    if not path:
        raise RuntimeError(f"{name} not found beside nvcc")
    return path


def sass(root: str, name: str, tag: str):
    """{kernel name: [instructions]} of ``root``'s csrc/<name>.cu."""
    src = os.path.join(root, "slak_tpu_torch", "ops", "csrc", f"{name}.cu")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",
                                                       "-Xcompiler", "-fPIC")]
    cubin = os.path.join(OUT_DIR, f"{tag}_{name}.cubin")
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", cubin, src],
                   check=True, capture_output=True, text=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                          check=True, capture_output=True, text=True).stdout
    with open(os.path.join(OUT_DIR, f"{tag}_{name}.sass"), "w") as f:
        f.write(text)
    return parse(text)


def parse(text: str):
    """{kernel name: [instructions]} of a ``cuobjdump -sass`` listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if cur is not None and m:
            funcs[cur].append(m.group(1).strip())
    return funcs


def compare(base, this):
    """[(kernel, instructions, identical, same up to parameter offsets)]."""
    def norm(ins):
        return [_PARAM.sub("c[param]", x) for x in ins]
    this_norm = [norm(v) for v in this.values()]
    return [(k, len(v), any(v == w for w in this.values()),
             norm(v) in this_norm) for k, v in base.items()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", help="another checkout of the repository")
    ap.add_argument("names", nargs="*", help="csrc/<name>.cu (default all)")
    args = ap.parse_args(argv)
    here = os.path.dirname(_build._PKG)           # this tree's root
    names = args.names or sorted(
        f[:-3] for f in os.listdir(os.path.join(args.base, "slak_tpu_torch",
                                                "ops", "csrc"))
        if f.endswith(".cu"))
    os.makedirs(OUT_DIR, exist_ok=True)
    with ThreadPoolExecutor(max(1, min(8, 2 * len(names)))) as ex:
        jobs = {n: (ex.submit(sass, args.base, n, "base"),
                    ex.submit(sass, here, n, "this")) for n in names}
    for n in names:
        rows = compare(jobs[n][0].result(), jobs[n][1].result())
        same = sum(r[2] for r in rows)
        near = sum(r[3] for r in rows)
        print(f"{n}.cu: {len(rows)} base kernels, {same} identical here, "
              f"{near} identical up to parameter offsets", flush=True)
        for k, count, ident, up_to in rows:
            print(f"  {count:6d} instructions  identical={ident}  "
                  f"up_to_param_offsets={up_to}  {k}", flush=True)


if __name__ == "__main__":
    main()
