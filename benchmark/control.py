"""The control of `correct`: the program with its blinding switched off.

    python benchmark/control.py --workload <name> --seeds 11,12,13 --seconds <s>

Sonic's prover blinds r(X, Y) with four random scalars a proof, so that a
proof reveals nothing of the witness. Proving with those scalars at zero
breaks that guarantee and changes no cost, and every proof still verifies:
the step that would tempt a later change. Here every request hands the
program randomness whose blinding is zero while the reference keeps the
request's, so each proof's r-dependent elements (pr_r, pr_t, pr_a,
pr_wa, pr_b, pr_wb and pr_wt: 7 of them) must differ and `correct` must
come out false. Each seed runs the cell's set-up and a window of
`--seconds` on one card, in this process (a one-chip cell only); one
line a seed gives the numbers compared, and the last line says whether
every seed came out not correct.
"""
import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def blinding_off(rnd):
    return dataclasses.replace(rnd, cns=[0] * len(rnd.cns))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    spec = harness.load_spec(args.workload)
    if spec.cell["chips"] != 1 or not torch.cuda.is_available():
        print("control: needs a one-chip cell and a CUDA card", file=sys.stderr)
        return 2
    caught = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(spec, seed, args.seconds, False, "cuda", to_program=blinding_off)
        caught.append(not res["correct"])
        print(json.dumps({"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    print(json.dumps({"workload": args.workload, "control_not_correct_on_every_seed": all(caught)}))
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    raise SystemExit(main())
