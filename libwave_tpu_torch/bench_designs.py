"""Time the shipped Hamming top-2, Hamming table and segment broadcast
against other designs of them on the card.

    python3 libwave_tpu_torch/bench_designs.py [table] [top2] [broadcast]

(all three parts without arguments) builds ``csrc/table_designs.cu`` and
``csrc/top2_broadcast_designs.cu`` (which include the shipped
``csrc/hamming.cu`` and ``csrc/segmm_seg.cu``) and prints, for each shape,
the device ms of one call of each design, read twice
(``bench_problem.device_ms``: a replayed CUDA graph), after checking that
each equals the plain version exactly:

- the table (W = 16) at 512 x 512 (the frame's shape), 4,096^2 and
  8,192^2: the shipped tensor-core kernel (``hamming_distance``, 64 x 64
  tiles), the first version's 32 x 32 tiles on the CUDA cores, a
  register-tiled CUDA-core kernel (4 x 4 outputs a thread), the shipped
  kernel at 128 x 128 tiles, the shipped launch through the designs'
  library, an empty kernel over the shipped grid; first the shipped kernel
  is held to the plain version at every W it takes and at ragged N1 and N2
  (``bench_frontend.table_edge_cases``), and the tensor cores' rate on
  ``mma.sync`` with .b1 and .s8 operands is measured (:func:`mma_rates`);

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
import functools
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


# (label, design) of csrc/table_designs.cu's table_design_w16
TABLE = [("first version, 32 x 32 tiles on the CUDA cores", 0),
         ("register-tiled CUDA cores, 4 x 4 a thread", 1),
         ("shipped kernel at 128 x 128 tiles", 2),
         ("shipped launch, 64 x 64 tiles", 3),
         ("empty kernel", 4)]
# operations counted per mma.sync instruction of csrc/table_designs.cu's
# mma_rate: m16n8k256 .b1 AND + add per bit pair; m16n8k32 .s8 multiply-add
MMA_OPS = {"b1": 2 * 16 * 8 * 256, "s8": 2 * 16 * 8 * 32}


@functools.cache
def table_library():
    """Build (or reuse) and load ``csrc/table_designs.cu``; returns the
    library and the compiler's ``-Xptxas -v`` report."""
    from libwave_tpu_torch.ops import _build

    lib, log = _build.load("table_designs", ["table_designs.cu"],
                           includes=("hamming.cu",))
    lib.table_design_w16.argtypes = [ctypes.c_int] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.table_design_w16.restype = ctypes.c_int
    lib.mma_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.mma_rate.restype = ctypes.c_int
    return lib, log


def table_design(design, d1, d2):
    """One launch of ``table_design_w16``'s ``design`` on int32 (N, 16)
    banks; returns the (N1, N2) int32 table."""
    import torch

    lib, _ = table_library()
    out = torch.empty((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                      device=d1.device)
    err = lib.table_design_w16(design, d1.data_ptr(), d2.data_ptr(),
                               out.data_ptr(), d1.shape[0], d2.shape[0],
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"table design {design}: CUDA error {err}")
    return out


def mma_rates(dev, iters=1000, reps=3):
    """Operations per second of ``mma.sync`` on the card, by operand type
    (``MMA_OPS``): 8 blocks of 8 warps per SM, each warp ``iters`` steps of
    8 independent products on register operands, timed as device time."""
    import torch

    from libwave_tpu_torch import bench_problem

    lib, _ = table_library()
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    rates = {}
    for op, (name, per) in enumerate(MMA_OPS.items()):
        def call(op=op):
            err = lib.mma_rate(op, blocks, iters, sink.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mma_rate {name}: CUDA error {err}")

        ms = bench_problem.device_ms(call, reps)
        rates[name] = blocks * 8 * iters * 8 * per / (ms * 1e-3)
    return rates


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


def table_cases(dev):
    """(name, d1, d2) int32 banks of W = 16 at the timed shapes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2)
    words = rng.integers(0, 2**32, (8192, 16), dtype=np.uint64)
    words = torch.as_tensor(words.astype(np.uint32).view(np.int32),
                            device=dev)
    near = words.flip(0).contiguous()
    return [("512x512x16", near[:512], words[:512]),
            ("4096x4096x16", near[:4096], words[:4096]),
            ("8192x8192x16", near, words)]


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
    import numpy as np
    import torch

    from libwave_tpu_torch import bench_frontend, bench_problem
    from libwave_tpu_torch.ops import hamming, segmm

    if not torch.cuda.is_available():
        sys.exit("bench_designs: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    parts = sys.argv[1:] or ["table", "top2", "broadcast"]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def twice(fn, reps):
        return ", ".join(f"{bench_problem.device_ms(fn, reps):.4f}"
                         for _ in range(2))

    if "table" in parts:
        _, log = table_library()
        for line in log.splitlines():
            if "table" in line or "mma" in line or "registers" in line:
                print(f"table designs: ptxas: {line.strip()}")
        cases = [(name, *(torch.as_tensor(x.view(np.int32), device=dev)
                          for x in banks))
                 for name, *banks in bench_frontend.table_edge_cases()]
        for name, d1, d2 in cases:
            got = hamming.hamming_distance(d1, d2)
            ref = hamming.hamming_distance_reference(d1, d2)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise SystemExit(f"table {name}: the shipped kernel differs "
                                 f"from the plain version at "
                                 f"{int((got != ref).sum())} entries")
        print(f"table designs: the shipped kernel equals the plain version "
              f"exactly at {len(cases)} cases: "
              f"{', '.join(c[0] for c in cases)}", flush=True)
        rates = mma_rates(dev)
        print("table designs: mma.sync rates on register operands: "
              + ", ".join(f"{k} {v:.4e} ops/s" for k, v in rates.items())
              + f" | {smi}", flush=True)
        for name, d1, d2 in table_cases(dev):
            reps = 20 if d1.shape[0] <= 512 else 5
            ref = hamming.hamming_distance_reference(d1, d2)
            times = [f"shipped "
                     f"{twice(lambda: hamming.hamming_distance(d1, d2), reps)}"]
            for label, design in TABLE:
                out = table_design(design, d1, d2)
                torch.cuda.synchronize()
                if label != "empty kernel" and not torch.equal(out, ref):
                    raise SystemExit(f"{name}: table design '{label}' "
                                     f"differs from the plain version")
                t = twice(lambda design=design: table_design(design, d1, d2),
                          reps)
                times.append(f"{label} {t}")
            print(f"table designs: {name}: device ms {'; '.join(times)} | "
                  f"{smi}", flush=True)
            del ref

    if "top2" not in parts and "broadcast" not in parts:
        return
    lib = _library()
    for name, d1, d2, mask in top2_cases(dev) if "top2" in parts else []:
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
    for name, C, idx, M in (broadcast_cases(dev) if "broadcast" in parts
                            else []):
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
