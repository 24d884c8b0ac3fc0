"""The readings the limits of ``check`` are set from (not part of a run):

    python3 gpubench/calibrate.py --workload NAME --seeds S1,S2,... \
        --control-seeds C1,C2,C3 [--seconds 4]

For each seed of ``--seeds``, one short run of the cell by the program
(``harness.run``, untraced) in this one process; for each seed of
``--control-seeds``, the control: the reference computed in float32 in
the program's place on the problems a run of that seed checks, judged by
the same numbers against the float64 reference.  One JSON line each.
"""

import argparse
import json
import os
import sys
import time

CONTROL_ROUNDS = 100


def control(name: str, seed: int, device: str) -> dict:
    """The control's numbers for seed ``seed``: x_gap and primal_viol of
    the float32 reference on the sampled problems of a run of
    ``CONTROL_ROUNDS`` rounds."""
    import torch

    from gpubench import check, harness, mixes, problems as pb

    spec = harness.load_cell(name)
    config, traffic = spec["config"], spec["traffic"]
    picks = mixes.sample(traffic, config, seed, CONTROL_ROUNDS)
    batches = mixes.pool(config, traffic, seed)
    ref64 = check.reference_solutions(config, traffic, seed, picks, device, batches)
    ref32 = check.reference_solutions(config, traffic, seed, picks, device, batches,
                                      dtype=torch.float32)
    gap = max(float(check.x_gaps(x32, x64).max()) for (x64, _), (x32, _) in zip(ref64, ref32))
    viol = 0.0
    for (r, idx), (x32, _) in zip(picks, ref32):
        probs = mixes.round_problems(config, traffic, seed, r, batches)
        dense = pb.dense_form(config, [probs[i] for i in idx], with_cost=False)
        viol = max(viol, check.primal_violation(dense, x32[None], device))
    return {"x_gap": gap, "primal_viol": viol,
            "ref_kkt": float(max(k for _, k in ref64)), "problems": int(sum(len(i) for _, i in picks))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gpubench import harness

    for s in filter(None, args.seeds.split(",")):
        t = time.perf_counter()
        result, numbers = harness.run(args.workload, int(s), args.seconds, False, t,
                                      device=args.device)
        print(json.dumps({"workload": args.workload, "side": "program", "seed": int(s),
                          "rounds": result["rounds"], "seconds": time.perf_counter() - t,
                          **{k: v for k, (v, _) in numbers.items()}}), flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        t = time.perf_counter()
        out = control(args.workload, int(s), args.device)
        print(json.dumps({"workload": args.workload, "side": "control", "seed": int(s),
                          "seconds": time.perf_counter() - t, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
