"""Count the CUDA kernels that one explicit-S LM iteration of the headline
problem launches, with ``torch.profiler``.

    python3 libwave_tpu_torch/launch_count.py [--root DIR]

prints one JSON line: the kernels that ran on the device in one
``optim.ba._lm_iteration`` (after a warm-up iteration), split by name
prefix (the package's own kernels, PyTorch's), and the runtime launch
calls the profiler saw. ``--root`` imports ``libwave_tpu_torch`` from the
checkout at DIR instead of this one, so that the same count can be taken of
another tree (such as the parent commit's). Needs a CUDA device.
``chip_smoke.py`` runs this script in a child process: ``torch.profiler``
leaves its hooks in the process that used it, and that process's later
launches are slower.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
_OWN = ("g_a_", "seg_reduce", "seg_broadcast", "top2", "table", "pcg_")


def kernel_launches(fn):
    """Run ``fn`` under ``torch.profiler`` and return ``(kernels,
    launch_calls, by_name)``: the kernels that ran on the device (copies and
    fills left out), the runtime launch calls seen on the host, and the
    kernels counted by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    launch_calls = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(("Memcpy", "Memset")):
                by_name[e.name] += 1
        elif e.name in _LAUNCH_CALLS:
            launch_calls += 1
    return sum(by_name.values()), launch_calls, by_name


def per_lm_iteration(problem, state, cfg):
    """Kernels of one LM iteration of ``optim.ba.solve_ba`` on ``problem``
    from ``state``: ``{"kernels", "own_kernels", "launch_calls"}``, where
    ``own_kernels`` counts the package's CUDA kernels among them."""
    import torch

    from libwave_tpu_torch.optim import ba

    lam = torch.full((), cfg.init_lambda, dtype=state.p.dtype,
                     device=state.p.device)
    carry = (state, lam, ba.ba_cost(problem, state, cfg.huber_delta),
             torch.zeros((), dtype=torch.bool, device=state.p.device))
    carry, _ = ba._lm_iteration(problem, cfg, carry)  # warm-up
    kernels, calls, by_name = kernel_launches(
        lambda: ba._lm_iteration(problem, cfg, carry))
    if kernels == 0:
        raise RuntimeError("torch.profiler recorded no kernel on the device")
    own = sum(v for k, v in by_name.items() if any(s in k for s in _OWN))
    return {"kernels": kernels, "own_kernels": own, "launch_calls": calls}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=None,
                        help="checkout to import libwave_tpu_torch from")
    args = parser.parse_args(argv)
    import torch

    from libwave_tpu_torch import bench_problem

    if not torch.cuda.is_available():
        sys.exit("launch_count: needs a CUDA device")
    problem, state = bench_problem.make_problem(device="cuda")
    counts = per_lm_iteration(problem, state, bench_problem.bench_config(1))
    counts["root"] = str((args.root or Path(__file__).parent.parent).resolve())
    print(json.dumps(counts))


if __name__ == "__main__":
    # run as a script: import the package from --root (default: the
    # checkout this file lies in), never from this file's own directory
    root = Path(__file__).resolve().parent.parent
    if "--root" in sys.argv:
        root = Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
    sys.path[0] = str(root)
    main()
