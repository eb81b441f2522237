"""``--profile``: a step under ``torch.profiler``, its device time by kernel
family and by attention kernel, its idle share, and a gzipped Chrome
trace.
"""
from __future__ import annotations

import json
import os
import re
import time

from .common import say


# kernel families of a profiled step: the first family whose pattern is in
# a kernel's name takes it
FAMILIES = (("attention bwd dkv", ("fa_bwd_dkv",)),
            ("attention bwd dq", ("fa_bwd_dq",)),
            ("attention fwd wgmma (onekv)", ("fa_fwd_onekv",)),
            ("attention fwd wgmma (generic, d64)", ("fa_fwd_wgmma",)),
            ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas",
                                 "nvjet")),
            ("reduction", ("reduce",)),
            ("elementwise", ("elementwise", "vectorized", "unrolled",
                             "copy", "fill", "memcpy", "memset")))


def family(kernel_name: str) -> str:
    """The family of ``FAMILIES`` that a device kernel's name falls in."""
    name = kernel_name.lower()
    return next((f for f, pats in FAMILIES if any(p in name for p in pats)),
                "other")


class ProfiledStep:
    """One step under ``torch.profiler`` (CPU and CUDA): ``begin()`` and
    ``end()`` around it, each of which synchronises the device first, then
    ``report()``, which writes the device's busy time (the union of its
    kernel intervals) by kernel family and by attention kernel, the idle
    share against the unprofiled CUDA-event time of the same step and
    against the profiled wall time, and the device time under the
    ``qlinear_*`` ranges, as ``<tag>_step_breakdown.json``, with a gzipped
    Chrome trace, to ``out_dir``, and returns it."""

    def __init__(self, tag, unprofiled_s, out_dir):
        from torch.profiler import ProfilerActivity, profile
        self.tag, self.unprofiled_s, self.out_dir = tag, unprofiled_s, out_dir
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def begin(self):
        import torch
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def end(self):
        import torch
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()

    def report(self):
        from torch.autograd import DeviceType
        os.makedirs(self.out_dir, exist_ok=True)
        tag, unprofiled_s, wall = self.tag, self.unprofiled_s, self.wall
        spans, families = [], {name: [0.0, 0] for name, _ in FAMILIES}
        families["other"] = [0.0, 0]
        kernels, ranges = {}, {}
        for ev in self.prof.events():
            if ev.name.startswith("qlinear_"):
                # a range: on the host, the device time of the kernels
                # launched under it; its span on the device's timeline is
                # not a kernel, and counts nowhere
                if ev.device_type == DeviceType.CPU:
                    ranges[ev.name] = ranges.get(ev.name, 0.0) + \
                        ev.device_time_total / 1e6
                continue
            if ev.device_type != DeviceType.CUDA:
                continue
            start, end = ev.time_range.start, ev.time_range.end
            spans.append((start, end))
            fam = family(ev.name)
            families[fam][0] += (end - start) / 1e6
            families[fam][1] += 1
            kname = re.search(r"fa_(fwd|bwd)\w*(<[^>]*>)?", ev.name)
            if kname:
                kern = kernels.setdefault(kname.group(0), [0.0, 0])
                kern[0] += (end - start) / 1e6
                kern[1] += 1
        if not spans:
            raise AssertionError("the profiler recorded no device activity")
        busy, reach = 0.0, float("-inf")
        for start, end in sorted(spans):
            if end > reach:
                busy += (end - max(start, reach)) / 1e6
                reach = end
        out = {"unprofiled_step_s": unprofiled_s, "profiled_wall_s": wall,
               "device_busy_s": busy,
               "idle_share": 1 - busy / unprofiled_s,
               "idle_share_under_profiler": 1 - busy / wall,
               "families": {f: {"device_s": t, "launches": n}
                            for f, (t, n) in sorted(families.items(),
                                                    key=lambda x: -x[1][0])},
               "attention_kernels": {k: {"device_s": t, "launches": n}
                                     for k, (t, n) in sorted(
                                         kernels.items(),
                                         key=lambda x: -x[1][0])},
               "ranges": ranges}
        with open(os.path.join(self.out_dir, f"{tag}_step_breakdown.json"),
                  "w") as f:
            json.dump(out, f, indent=1)
        self.prof.export_chrome_trace(os.path.join(
            self.out_dir, f"{tag}_step_trace.json.gz"))
        say(f"profile_{tag}", unprofiled_step_s=f"{unprofiled_s:.3f}",
            profiled_wall_s=f"{wall:.3f}", device_busy_s=f"{busy:.3f}",
            idle_share=f"{out['idle_share']:.4f}",
            idle_share_under_profiler=(
                f"{out['idle_share_under_profiler']:.4f}"),
            families=json.dumps({f: round(v["device_s"], 3) for f, v in
                                 out["families"].items()}).replace(" ", ""),
            attention=json.dumps({k: round(v["device_s"], 3) for k, v in
                                  out["attention_kernels"].items()}
                                 ).replace(" ", ""))
        return out
