"""Time the shipped Hamming top-2 and segment broadcast against other designs
of them on the card.

    python3 libwave_tpu_torch/bench_designs.py

builds ``csrc/top2_broadcast_designs.cu`` (which includes the shipped
``csrc/hamming.cu`` and ``csrc/segmm_seg.cu``) and prints, for each shape,
the device ms of one call of each design, read twice
(``bench_problem.device_ms``: a replayed CUDA graph), after checking that
each equals the plain version exactly:

- the top-2 (W = 16) at 512 x 512 (the frame's shape, a tenth of the
  columns masked), 2,048^2 and 16,384^2 (random banks of near copies): the
  shipped kernel (``hamming_top2``, which picks its own lanes, rows per
  thread and block size), the first version's thread per query row, the
  split kernel at 1 and 4 rows per thread and 4, 8, 16 and 32 lanes per
  row, at 64 and 128 lanes per row (blocks of 256 and 512), the split
  kernel reading the bank through L1 instead of shared memory, an empty
  kernel over the shipped grid;
- the broadcast (f32) at the seg phase's four timed shapes: the headline's
  C = 3 and C = 6 (K = 60,000, M = 10,000), the matrix-free profile's
  K = 480,000 and ``ba_large``'s problem
  (``bench_problem.ba_large_problem``: K = 600,000, M = 100,000, its ids
  ordered by bearing), and that problem at C = 6 and at 20,000,
  30,000, 40,000 and 60,000 landmarks (y from 240 KB to 1.2 MB at C = 3):
  the shipped kernel (``seg_broadcast``), the first version's thread per
  (channel, slot), 4 slots for all channels per thread in blocks of 64 and
  of 256, 1 slot for all channels, 2 slots of one channel, the shipped
  striding kernel with plain stores, with y read through L2 only, with
  the ids loaded evict-first and at any size of y, the first version with
  the ids loaded evict-first, an empty kernel.

Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

# (label, design, lanes) of csrc/top2_broadcast_designs.cu's top2_design_w16
TOP2 = [("first version, thread per row", 0, 1)] + [
    (f"shared {rows} row{'s' if rows > 1 else ''} x {lanes} lanes",
     1 if rows == 1 else 2, lanes)
    for rows in (1, 4) for lanes in (4, 8, 16, 32)
] + [("shared 1 row x 64 lanes (256 threads)", 1, 64),
     ("shared 1 row x 128 lanes (512 threads)", 1, 128),
     ("L1 1 row x 32 lanes", 4, 32), ("L1 4 rows x 16 lanes", 5, 16),
     ("L1 4 rows x 32 lanes", 5, 32), ("empty kernel", 3, 1)]
# (label, design) of its broadcast_design_f32
BROADCAST = [("first version, thread per (channel, slot)", 0),
             ("4 slots all channels, blocks of 64", 1),
             ("4 slots all channels, blocks of 256", 2),
             ("1 slot all channels, blocks of 256", 3),
             ("2 slots one channel, blocks of 256", 4),
             ("shipped striding, plain stores", 5),
             ("shipped striding, y through L2 only", 6),
             ("first version, ids evict-first", 8),
             ("shipped striding, ids evict-first", 9),
             ("shipped striding at any y", 10),
             ("empty kernel", 7)]


def _library():
    from libwave_tpu_torch.ops import _build

    lib, _ = _build.load("top2_broadcast_designs",
                         ["top2_broadcast_designs.cu"],
                         includes=("hamming.cu", "segmm_seg.cu"))
    lib.top2_design_w16.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.top2_design_w16.restype = ctypes.c_int
    lib.broadcast_design_f32.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.broadcast_design_f32.restype = ctypes.c_int
    return lib


def top2_cases(dev):
    """(name, d1, d2, mask2) int32 banks on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2)
    words = rng.integers(0, 2**32, (16384, 16), dtype=np.uint64)
    words = words.astype(np.uint32).view(np.int32)
    near = words[rng.permutation(16384)].copy()
    near ^= (rng.random(near.shape) < 0.05).astype(np.int32) << 7
    d2 = torch.as_tensor(words, device=dev)
    d1 = torch.as_tensor(near, device=dev)
    mask = torch.as_tensor(rng.random(512) < 0.9, device=dev)
    return [("512x512x16, a tenth masked", d1[:512], d2[:512], mask),
            ("2048x2048x16", d1[:2048], d2[:2048], None),
            ("16384x16384x16", d1, d2, None)]


def broadcast_cases(dev):
    """(name, C, idx, M) at the seg phase's timed shapes, and ``ba_large``'s
    problem at C = 6 and at fewer landmarks."""
    from libwave_tpu_torch import bench_problem

    headline, _ = bench_problem.make_problem(device=dev)
    profile, _ = bench_problem.make_problem(obs_per_pose=2400, device=dev)
    M = headline.bands.entries[-1][1]
    large = bench_problem.ba_large_problem(device=dev)[0].lm_idx
    cases = [("headline C=3", 3, headline.lm_idx, M),
             ("headline C=6", 6, headline.lm_idx, M),
             ("profile K=480,000 C=3", 3, profile.lm_idx, M),
             ("ba_large K=600,000 M=100,000 C=3", 3, large, 100_000),
             ("ba_large K=600,000 M=100,000 C=6", 6, large, 100_000)]
    for m in (20_000, 30_000, 40_000, 60_000):
        cases.append((f"ba_large problem at M={m:,} C=3", 3,
                      bench_problem.ba_large_problem(m, dev)[0].lm_idx, m))
    return cases


def main():
    import torch

    from libwave_tpu_torch import bench_problem
    from libwave_tpu_torch.ops import hamming, segmm

    if not torch.cuda.is_available():
        sys.exit("bench_designs: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    lib = _library()
    dev = torch.device("cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def twice(fn, reps):
        return ", ".join(f"{bench_problem.device_ms(fn, reps):.4f}"
                         for _ in range(2))

    for name, d1, d2, mask in top2_cases(dev):
        n1, n2 = d1.shape[0], d2.shape[0]
        reps = 20 if n1 <= 2048 else 3
        ref = hamming.hamming_top2_reference(d1, d2, mask)
        times = [f"shipped "
                 f"{twice(lambda: hamming.hamming_top2(d1, d2, mask), reps)}"]
        for label, design, lanes in TOP2:
            outs = [torch.empty(n1, dtype=torch.int32, device=dev)
                    for _ in range(3)]

            def call(design=design, lanes=lanes, outs=outs):
                err = lib.top2_design_w16(
                    design, lanes, d1.data_ptr(), d2.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    *(o.data_ptr() for o in outs), n1, n2, stream())
                if err:
                    raise RuntimeError(f"top-2 design {design}: CUDA error "
                                       f"{err}")

            call()
            torch.cuda.synchronize()
            if label != "empty kernel" and not all(
                    torch.equal(o, r) for o, r in zip(outs, ref)):
                raise SystemExit(f"{name}: top-2 design '{label}' differs "
                                 f"from the plain version")
            times.append(f"{label} {twice(call, reps)}")
        print(f"top2 designs: {name}: device ms {'; '.join(times)} | {smi}",
              flush=True)

    gen = torch.Generator(device=dev).manual_seed(6)
    for name, C, idx, M in broadcast_cases(dev):
        K = idx.shape[0]
        y = torch.randn((C, M), generator=gen, device=dev)
        ref = segmm.seg_broadcast_reference(y, idx)
        times = [f"shipped {twice(lambda: segmm.seg_broadcast(y, idx), 20)}"]
        for label, design in BROADCAST:
            out = torch.empty((C, K), device=dev)

            def call(design=design, out=out):
                err = lib.broadcast_design_f32(
                    design, y.data_ptr(), idx.data_ptr(), out.data_ptr(), C,
                    K, M, stream())
                if err:
                    raise RuntimeError(f"broadcast design {design}: CUDA "
                                       f"error {err}")

            call()
            torch.cuda.synchronize()
            if label != "empty kernel" and not torch.equal(out, ref):
                raise SystemExit(f"{name}: broadcast design '{label}' differs "
                                 f"from the plain version")
            times.append(f"{label} {twice(call, 20)}")
        print(f"broadcast designs: {name}: device ms {'; '.join(times)} | "
              f"{smi}", flush=True)


if __name__ == "__main__":
    # run as a script: import the package from the checkout this file is in
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    main()
