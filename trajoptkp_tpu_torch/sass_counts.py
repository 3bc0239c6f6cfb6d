"""SASS instruction counts of the kernels, per library and kernel, on the
machine with the card (needs nvcc and cuobjdump).

    python -m trajoptkp_tpu_torch.sass_counts --json change.json
    python -m trajoptkp_tpu_torch.sass_counts \
        --dir OTHER/trajoptkp_tpu_torch/kernels/_build --json parent.json
    python -m trajoptkp_tpu_torch.sass_counts --compare parent.json change.json
    python -m trajoptkp_tpu_torch.sass_counts --sources ad_jacobian,backward \
        --instances push_lcl,nx38_nu7 --resources

Disassembles each (source, instance) library of `--sources` with
`cuobjdump -sass` and counts the instructions of every kernel function:
this tree's libraries (built first where missing, kernels/build.py), or
the ones already built in another checkout's `--dir` (build them there
with its own kernels/build.py).  `--compare` prints, per kernel, the two
counts where they differ: an edit to shared device code that leaves a
kernel's count alone left its machine code alone in all likelihood, and a
count that moved names the kernel to time (bench_kernels.py, both trees
in one job).  `--instances` keeps the libraries of those instances (push_lcl,
nx38_nu7, ...); `--resources` prints each kernel's registers, stack frame
and local memory (`cuobjdump -res-usage`) beside its count.  The seconds
each library's nvcc took and its spill stores are in the build's ptxas
log, which chip_smoke.py prints and records (`nvcc`).
"""

import argparse
import json
import os
import pathlib
import re
import subprocess

from trajoptkp_tpu_torch.kernels import build

DEFAULT_SOURCES = ("rollout", "linesearch", "fd_jacobian", "cost_expansion",
                   "mpc_apply", "backward")
_INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S")
_RES = re.compile(r"REG:(\d+)\s+STACK:(\d+)\s+SHARED:(\d+)\s+LOCAL:(\d+)")


def cuobjdump() -> str:
    return os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")


def counts_of(lib: pathlib.Path) -> dict:
    """{kernel function: instructions} of one library."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = 0
        elif name is not None and _INSTR.match(line):
            counts[name] += 1
    return counts


def resources_of(lib: pathlib.Path) -> dict:
    """{kernel function: {registers, stack, local}} of one library."""
    out = subprocess.run([cuobjdump(), "-res-usage", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    res, name = {}, None
    for line in out.splitlines():
        if "Function " in line:
            name = line.split("Function ", 1)[1].strip().rstrip(":")
        m = _RES.search(line)
        if name is not None and m:
            res[name] = dict(registers=int(m.group(1)),
                             stack=int(m.group(2)), local=int(m.group(4)))
    return res


def built_in(build_dir: pathlib.Path, libs) -> dict:
    """The libraries of another checkout's build directory -> paths."""
    paths = {}
    for source, instance in libs:
        found = sorted(build_dir.glob(f"{source}-{instance}-*.so"))
        if not found:
            raise FileNotFoundError(f"no {source}-{instance} library in "
                                    f"{build_dir}")
        paths[(source, instance)] = found[-1]
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sources", default=",".join(DEFAULT_SOURCES))
    ap.add_argument("--dir", help="another checkout's kernels/_build")
    ap.add_argument("--json", help="write the counts here too")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--instances", help="only these instances' libraries")
    ap.add_argument("--resources", action="store_true",
                    help="registers, stack and local memory per kernel")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        moved = {lib: {k: (a[lib].get(k), n) for k, n in kern.items()
                       if a.get(lib, {}).get(k) != n}
                 for lib, kern in b.items()}
        moved = {lib: m for lib, m in moved.items() if m}
        print(json.dumps({"libraries": len(b), "moved": moved}))
        return
    sources = args.sources.split(",")
    libs = [lib for lib in build.libraries(lazy=True) if lib[0] in sources]
    if args.instances:
        libs = [lib for lib in libs if lib[1] in args.instances.split(",")]
    if args.dir:
        paths = built_in(pathlib.Path(args.dir), libs)
    else:
        build.build(libs)
        paths = {lib: build.library_path(*lib) for lib in libs}
    counts = {f"{s}-{i}": counts_of(p) for (s, i), p in paths.items()}
    out = {"counts": counts}
    if args.resources:
        out["resources"] = {f"{s}-{i}": resources_of(p)
                            for (s, i), p in paths.items()}
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(counts, f)


if __name__ == "__main__":
    main()
