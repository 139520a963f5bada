"""Time the shipped segment reduce against other designs of it on the card.

    python3 libwave_tpu_torch/bench_seg_designs.py

builds ``csrc/seg_reduce_designs.cu`` (the first version's one thread per
(channel, landmark) unrolled by 4, a lane group of 8 per landmark with a
shuffle fold, one thread per landmark for all channels, the shipped
layout in blocks of 512, an empty kernel) and prints, for the headline
layout and the matrix-free profile's K = 480,000 at C = 3 and 6, and
``ba_large``'s K = 600,000, M = 100,000 (random ids), the device ms of one
call of each, timed twice (``bench_problem.device_ms``: a replayed CUDA
graph), after checking that each equals the plain version bit for bit.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

DESIGNS = ("per (channel, landmark), unroll 4", "lane group of 8, shuffle fold",
           "per landmark, all channels, 8 in flight",
           "per (channel, landmark), 8 in flight, 512-landmark blocks",
           "empty kernel")


def _library():
    from libwave_tpu_torch.ops import _build

    lib, _ = _build.load("seg_reduce_designs", ["seg_reduce_designs.cu"])
    fn = lib.seg_reduce_design_f32
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cases(dev):
    """(name, C, EllLayout) at the shapes the port's reduce runs."""
    import torch

    from libwave_tpu_torch import bench_problem
    from libwave_tpu_torch.ops import segmm

    headline, _ = bench_problem.make_problem(device=dev)
    profile, _ = bench_problem.make_problem(obs_per_pose=2400, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    large = torch.randint(0, 100_000, (600_000,), generator=gen, device=dev,
                          dtype=torch.int32)
    return [("headline C=3", 3, headline.ell), ("headline C=6", 6, headline.ell),
            ("profile K=480,000 C=3", 3, profile.ell),
            ("profile K=480,000 C=6", 6, profile.ell),
            ("ba_large K=600,000 M=100,000 C=3", 3,
             segmm.sorted_layout(large, 100_000))]


def main():
    import torch

    from libwave_tpu_torch import bench_problem
    from libwave_tpu_torch.ops import segmm

    if not torch.cuda.is_available():
        sys.exit("bench_seg_designs: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    design = _library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)

    def twice(fn):
        return ", ".join(f"{bench_problem.device_ms(fn):.4f}" for _ in range(2))

    for name, C, (sigma, offsets) in cases(dev):
        K, M = sigma.shape[0], offsets.shape[0] - 1
        vals = torch.randn((C, K), generator=gen, device=dev)
        ref = segmm.seg_reduce_sorted_reference(vals, sigma, offsets)
        shipped = twice(lambda: segmm.seg_reduce_sorted(vals, sigma, offsets))
        times = [f"shipped {shipped}"]
        for d, label in enumerate(DESIGNS):
            out = torch.empty((C, M), device=dev)

            def call(d=d, out=out):
                err = design(d, vals.data_ptr(), sigma.data_ptr(),
                             offsets.data_ptr(), out.data_ptr(), C, K, M,
                             torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"design {d}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            if label != "empty kernel" and not torch.equal(out, ref):
                raise SystemExit(f"{name}: design '{label}' differs from the "
                                 f"plain version")
            times.append(f"{label} {twice(call)}")
        print(f"seg designs: {name}: device ms {'; '.join(times)} | {smi}",
              flush=True)


if __name__ == "__main__":
    # run as a script: import the package from the checkout this file is in
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    main()
