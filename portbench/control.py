"""Readings that set a cell's limits: the program's and the control's.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, at the cell's own sizes and settings, on the card: the
port's solve (the timed call, ``solve_ba``) and the control (the plain
reference put in the program's place, computed in TF32, the precision below
the configuration's float32) are each compared with the float32 reference,
by the numbers ``portbench.harness.check`` compares. The program's largest
readings over a dozen seeds or more are the lower readings of the limits,
the control's smallest the upper ones. One JSON line per seed goes to
standard output (and to ``--out``). The benchmark's own runs never run the
control.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings_for_seed(cell, seed, device):
    """``{"seed", "program", "control", "*_s"}`` for one seed: each side's
    compared numbers against the float32 reference, and the seconds each
    solve took."""
    import torch

    from portbench.harness import check, port
    from portbench.harness.scene import make_scene
    from portbench.reference import ba_ref

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {"seed": seed}
    scene = make_scene(cell.config, cell.traffic, seed, device)
    settings = port.settings(cell.config, cell.traffic)
    problem, state0, cfg = port.build(scene, cell.config, cell.traffic,
                                      device)
    t = time.perf_counter()
    state, info = port.solve(problem, state0, cfg)
    answer = check.answer_of(state, info)
    out["program_s"] = time.perf_counter() - t
    out["cg_iterations"] = [int(c) for c in info["cg_iterations"].cpu()]
    del problem, state, info
    check.free_device_memory()
    t = time.perf_counter()
    reference = check.reference_solve(scene, settings)
    sync()
    out["reference_s"] = time.perf_counter() - t
    out["program"] = check.readings(scene, answer, reference)
    t = time.perf_counter()
    ctl = check.reference_solve(scene, settings, ba_ref.tf32)
    sync()
    out["control_s"] = time.perf_counter() - t
    out["control"] = check.readings(scene, ctl, reference)
    out["reference_costs"] = reference[4]
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench.harness import spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings_for_seed(cell, seed, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
