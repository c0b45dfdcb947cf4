"""The device side of a run: the card's name, memory peaks, and the
profiled slice of a traced window (``torch.profiler`` with CUDA activity
only), reduced to the intervals in which an operation ran on the device."""

from __future__ import annotations

import heapq
import subprocess
import time

import torch


def card() -> dict:
    """Name and power limit of card 0 (``nvidia-smi``), for the log."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": out[0] if out else ""}


def union_ns(intervals: list) -> list:
    """Sorted, merged [start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(merged: list, lo: int, hi: int) -> list:
    return [[max(s, lo), min(e, hi)] for s, e in merged if e > lo and s < hi]


class Slice:
    """A profiled slice: start it, stop it, then read ``ops`` (name, start
    ns, end ns of every kernel, copy and set on the device, on the host's
    wall clock, as kineto reports them) against ``[t0_ns, t1_ns]``, and
    ``p0``/``p1``, the same bounds on ``time.perf_counter``."""

    def __init__(self):
        self.prof = None
        self.ops: list = []
        self.t0_ns = self.t1_ns = 0
        self.p0 = self.p1 = 0.0

    @staticmethod
    def warm() -> None:
        """Profile a moment of nothing, so that the profiler's first start
        (CUPTI's set-up) falls in set-up and not in the window."""
        s = Slice()
        s.start()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        s.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0_ns, self.p0 = time.time_ns(), time.perf_counter()

    def stop(self) -> None:
        from torch.autograd import DeviceType

        self.t1_ns, self.p1 = time.time_ns(), time.perf_counter()
        torch.cuda.synchronize()
        self.prof.stop()
        res = self.prof.profiler.kineto_results
        self.ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in res.events()
                    if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        self.prof = None

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy(self) -> list:
        """The merged busy intervals inside the slice."""
        return clip(union_ns([(s, e) for _, s, e in self.ops]), self.t0_ns, self.t1_ns)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time in the slice, by name."""
        tot: dict = {}
        for name, s, e in self.ops:
            s, e = max(s, self.t0_ns), min(e, self.t1_ns)
            if e > s:
                tot[name[:120]] = tot.get(name[:120], 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: list, n: int = 10) -> list:
        """Idle time of the device inside the slice, summed by what the host
        was doing: the innermost program span (``spans``: name, start ns,
        end ns on the wall clock) that covers a gap's middle, or ``none``."""
        gaps, at = [], self.t0_ns
        for s, e in self.busy():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.t1_ns:
            gaps.append((at, self.t1_ns))
        # a sweep over span starts and ends and gap middles in time order,
        # the covering spans in a heap by duration (ended ones dropped late)
        events = sorted([(s, 0, i) for i, (_, s, _) in enumerate(spans)]
                        + [((a + b) // 2, 1, j) for j, (a, b) in enumerate(gaps)])
        live: list = []
        tot: dict = {}
        for t, kind, i in events:
            if kind == 0:
                name, s, e = spans[i]
                heapq.heappush(live, (e - s, e, name))
                continue
            while live and live[0][1] <= t:
                heapq.heappop(live)
            key = live[0][2] if live else "none"
            a, b = gaps[i]
            tot[key] = tot.get(key, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
