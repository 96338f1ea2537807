"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root. The cell, its configuration, traffic and
metrics come from BENCHMARK.json and the files it names (`harness`). The
last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device and, last, the checks, each number compared
beside its limit; the check lines also end standard error.

A cell of one chip runs in this process. A cell of several starts one
rank a card (`python -m torch.distributed.run --standalone`, NCCL): every
rank runs the cell with `mesh=`, rank 0 writes its result to a file in a
temporary directory, and this process prints it once every rank has
ended. No result is printed, and the exit code is not 0, without CUDA or
with fewer cards than the cell asks for, or when a rank fails.
"""
import time

T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)  # a rank: the launcher's start
    p.add_argument("--result", default=None, help=argparse.SUPPRESS)  # a rank: where rank 0 writes
    return p.parse_args(argv)


def _chips(workload: str) -> int:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    return cells[workload]["chips"]


def _launch(chips: int, argv) -> int:
    """One rank a card; rank 0's result printed here once all have ended."""
    tmp = tempfile.mkdtemp(prefix="sonic-bench-")
    try:
        path = os.path.join(tmp, "result.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={chips}",
               os.path.abspath(__file__), *argv, "--t0", repr(T0), "--result", path]
        rc = subprocess.run(cmd, cwd=ROOT).returncode
        if rc != 0:
            print(f"run: the ranks exited with {rc}", file=sys.stderr)
            return rc or 1
        with open(path) as f:
            result = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from benchmark import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"run: these modules are loaded in the process that prints the result: {bad}", file=sys.stderr)
        return 1
    harness.emit(result)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = _args(argv)
    chips = _chips(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run: {args.workload} needs {chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    if chips > 1 and args.result is None:
        return _launch(chips, argv)
    from benchmark import harness

    spec = harness.load_spec(args.workload)
    if args.result is None:
        result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
        harness.emit(result)
        return 0
    from sonic_tpu_torch.parallel import distributed

    with distributed.launched_mesh() as mesh:
        device = torch.device("cuda", torch.cuda.current_device())
        result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), device, mesh, t0=args.t0)
    if result is not None:
        with open(args.result, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT  # the repository's root, not benchmark/: the port and `benchmark` import from it
    raise SystemExit(main())
