#!/usr/bin/env python3
"""Compare the ptxas reports of the port's CUDA libraries on two trees.

    python3 tools/ptxas_diff.py --old TREE --new TREE [--lib NAME ...]

Builds each library (`csrc/<NAME>.cu`, the flags of its wrapper; by
default those that include the MG headers) in each tree's own build
directory, one nvcc process a library and tree, all at once, and pairs
the kernels of the two reports by their demangled signature (`c++filt`;
the anonymous namespace left out).  A kernel that became a template on
its plane type pairs with the one it was: its float instantiation reads
as the old name (`signatures`).  For
each library it prints how many of the old tree's kernels repeat their
registers, stack, spills and shared memory in the new tree, the ones
that do not, and the new tree's kernels the old one lacks (those with a
double in their signature counted apart).  Run it on a machine with
nvcc, on trees whose build directory holds no library yet.  Exits 1 when
a kernel of the old tree differs or has no partner.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import re
import subprocess
import sys

# the libraries that include csrc/mg_solver.cuh, with the nvcc flags of
# their wrappers (ops/cuda/*_kernel.py)
LIBS = {"pcg_shard": ["-fmad=false"], "pcg_mg_blocks": ["-fmad=false"],
        "pcg_mg": ["-fmad=false"], "mg_pcg": [],
        "mg_stream": ["-fmad=false"]}

BUILD = """
import sys
from euler_tpu_torch.ops.cuda import _build
_build.load({name!r}, flags={flags!r})
sys.stdout.write(_build.BUILD_LOG[{name!r}]["ptxas"])
"""


def report(tree: str, name: str) -> str:
    """The ptxas report of `name` built in `tree` (empty when the library
    was already built there: remove the tree's build directory first)."""
    proc = subprocess.run(
        [sys.executable, "-c", BUILD.format(name=name, flags=LIBS[name])],
        cwd=tree, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{tree}: building {name} failed:\n{proc.stderr}")
    return proc.stdout


def kernels(text: str) -> dict:
    """{mangled name: [its report lines]} of a ptxas -v report."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out[m.group(1)] = []
        elif cur is not None and ("Used" in line or "stack frame" in line):
            cur.append(re.sub(r"^ptxas info\s*:\s*", "", line.strip()))
    return out


def signatures(names) -> list[str]:
    """Each kernel's demangled signature without its namespace, read so
    that a kernel made a template on its plane type names its float
    instantiation as it named the kernel before: `<float>` and a last
    template argument `float` dropped, `BlockEdges<float>` and
    `Ring0<float>` read as `BlockEdges` and `Ring0`."""
    dem = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.splitlines()
    out = []
    for d in dem:
        d = re.sub(r"\(anonymous namespace\)::", "", d)
        d = re.sub(r"^void ", "", d)
        d = re.sub(r"\s+>", ">", d)
        d = d.replace("BlockEdges<float>", "BlockEdges")
        d = d.replace("Ring0<float>", "Ring0")
        d = re.sub(r"<float>\(", "(", d, count=1)
        d = re.sub(r", float>\(", ">(", d, count=1)
        out.append(d)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True)
    ap.add_argument("--new", required=True)
    ap.add_argument("--lib", action="append", choices=sorted(LIBS))
    args = ap.parse_args(argv)
    libs = args.lib or sorted(LIBS)
    with concurrent.futures.ThreadPoolExecutor(2 * len(libs)) as pool:
        futs = {(t, n): pool.submit(report, t, n)
                for t in (args.old, args.new) for n in libs}
        texts = {k: f.result() for k, f in futs.items()}
    bad = 0
    for name in libs:
        old, new = (kernels(texts[(t, name)]) for t in (args.old, args.new))
        if not old or not new:
            print(f"{name}: no ptxas report (already built?)")
            bad += 1
            continue
        ko = dict(zip(signatures(old), old.values()))
        kn = dict(zip(signatures(new), new.values()))
        same = [k for k in ko if kn.get(k) == ko[k]]
        differ = [k for k in ko if k in kn and kn[k] != ko[k]]
        gone = [k for k in ko if k not in kn]
        added = [k for k in kn if k not in ko]
        doubles = sum("double" in k for k in added)
        print(f"{name}: {len(same)} of the old tree's {len(ko)} kernels "
              f"repeat their report, {len(differ)} differ, {len(gone)} have "
              f"no partner; {len(added)} new ({doubles} in double)")
        for k in differ:
            print(f"  differs: {k}\n    old {ko[k]}\n    new {kn[k]}")
        for k in gone:
            print(f"  no partner: {k}")
        for k in added:
            if re.search(r"[1-9]\d* bytes spill stores", " ".join(kn[k])):
                print(f"  new, spills: {k} {kn[k]}")
        bad += len(differ) + len(gone)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
