"""How far the plain G/A build's rounding moves from run to run on the card.

    python tests/ga_plain_spread.py

builds ``tests/test_torch_cuda.py::test_kernel_matches_plain``'s inputs for
two of its cases (a third of each pose's slots share one landmark id), then
runs the G/A kernel and its plain version 20 times on the same inputs. It
prints, for each case, whether the kernel's G and A are bit-identical across
runs, and the spread of max|kernel - plain| / max|plain| over the 20 plain
runs: the plain version sums duplicate ids with ``scatter_add_``, whose
order on the card follows its atomics. Card only; not a test (pytest does
not collect it); a few seconds after the kernel's build.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    # run as a script: import the port and the card tests from this checkout
    sys.path.insert(0, str(HERE.parent))
    sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_cuda  # noqa: E402
from libwave_tpu_torch.ops import segmm  # noqa: E402

CASES = [(3, 700, 257, 0, 257), (4, 300, 1024, -250, 1300)]
RUNS = 20


def main():
    dev = torch.device("cuda")
    for case in CASES:
        W, ids, hinv = test_torch_cuda._inputs(np.random.default_rng(0), dev,
                                               *case)
        G0, A0 = segmm.dense_g_a(W, ids, hinv)
        same, rel = [], []
        for _ in range(RUNS):
            G, A = segmm.dense_g_a(W, ids, hinv)
            Gr, Ar = segmm.dense_g_a_reference(W, ids, hinv)
            same.append(bool(torch.equal(G, G0) and torch.equal(A, A0)))
            rel.append(max(float((x - r).abs().max()) / float(r.abs().max())
                           for x, r in ((G, Gr), (A, Ar))))
        print(f"{case}: kernel bit-identical across runs: {all(same)}; "
              f"max|kernel - plain| / max|plain| over {RUNS} plain runs: "
              f"min {min(rel):.3e}, max {max(rel):.3e}, "
              f"over 1e-6: {sum(r > 1e-6 for r in rel)}")


if __name__ == "__main__":
    main()
