"""Does a ``utils.trace.profile_trace`` session record the package's segment
reduce kernel after what ran before it in the same process?

    python tests/profiler_histories.py HISTORY

HISTORY is a ``+``-joined list of steps run before the session: ``fresh``
(none), ``torch`` (a profiler session of PyTorch ops), ``seg`` (a session of
the segment reduce), ``many`` (a session of 60,000 launches), ``graph`` (a
CUDA graph of the reduce, as ``bench_problem.device_ms`` times it),
``export`` (a session exported as a Chrome trace), ``keyavg`` (a session's
``key_averages``), ``syncdebug`` (a call under sync debug mode),
``streams`` (a call on a side stream). Prints one JSON line: whether the
session's trace.json and its sums by kernel name the kernel. Card only;
not a test (pytest does not collect it); one history a process, ~15 s.
"""

import json
import sys
import tempfile
from pathlib import Path

if __name__ == "__main__":
    # run as a script: import the port from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from libwave_tpu_torch import bench_problem  # noqa: E402
from libwave_tpu_torch.ops import segmm  # noqa: E402
from libwave_tpu_torch.utils.trace import profile_trace  # noqa: E402


def main(history):
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randn((6, 480_000), generator=g, device=dev)
    ell = segmm.sorted_layout(torch.randint(0, 10_000, (480_000,),
                                            generator=g, device=dev), 10_000)

    def reduce():
        return segmm.seg_reduce_sorted(vals, *ell)

    def session(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        return p

    reduce()
    torch.cuda.synchronize()
    for step in history.split("+"):
        if step == "torch":
            session(lambda: [(vals * 2.0).sum() for _ in range(10)])
        elif step == "seg":
            session(reduce)
        elif step == "many":
            session(lambda: [vals[:, :1000] + 1.0 for _ in range(60_000)])
        elif step == "graph":
            bench_problem.device_ms(reduce, 20)
        elif step == "export":
            with tempfile.TemporaryDirectory() as tmp:
                session(reduce).export_chrome_trace(str(Path(tmp) / "a.json"))
        elif step == "keyavg":
            session(reduce).key_averages()
        elif step == "syncdebug":
            torch.cuda.set_sync_debug_mode("warn")
            reduce()
            torch.cuda.set_sync_debug_mode(0)
        elif step == "streams":
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                reduce()
            torch.cuda.synchronize()
        elif step != "fresh":
            raise SystemExit(f"unknown step {step!r}")
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp) as prof:
            for _ in range(5):
                reduce()
            torch.cuda.synchronize()
        text = (Path(tmp) / "trace.json").read_text()
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    print(json.dumps({
        "variant": history,
        "trace_names_kernel": "seg_reduce_sorted_kernel" in text,
        "keyavg_names_kernel": any("seg_reduce_sorted_kernel" in e.key
                                   for e in cuda),
        "cuda_keys": [e.key[:40] for e in cuda][:5],
        "trace_bytes": len(text)}))


if __name__ == "__main__":
    main(sys.argv[1])
