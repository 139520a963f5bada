"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics (``BENCHMARK.json``'s ``end_to_end``), with
``--trace 1`` its per-layer metrics, read from ``torch.profiler`` over a
bounded number of whole solves. The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
the check compared, each beside its limit.

Exits non-zero and prints no result when there is no CUDA card (or fewer
than the cell asks for), when the port cannot be imported, or when JAX,
jaxlib, flax or the JAX package ``libwave_tpu`` is loaded after the window.
The kernels' ``nvcc`` output stays where the port builds it, inside the
checkout (``libwave_tpu_torch/_build``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "libwave_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print("portbench: JAX or the JAX package was loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in out.check_lines:
        print(line, file=sys.stderr)
    print(json.dumps(_finite(out.result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
