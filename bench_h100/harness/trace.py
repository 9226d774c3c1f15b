"""The traced stretch of a window: a ``torch.profiler`` capture (CPU and
CUDA activities) kept in memory, read into kernel times, the device's busy
time and its idle gaps labelled by the benchmark span the host was in.

The profiler now and then loses the first or last kernels of a capture,
so each end of the stretch is closed by ten ~0.1 ms spin kernels
(``torch.cuda._sleep``) and a synchronize: the spins are lost instead of
the program's kernels, and are left out of every number."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

GUARDS, GUARD_CYCLES, GUARD_KERNEL = 10, 200_000, "spin_kernel"
STRETCH = "bench.stretch"
SHORT_GAP_S = 20e-6  # shorter idle gaps count as "between_kernels"


@dataclasses.dataclass
class Trace:
    window_s: float                  # the stretch's length
    busy_s: float                    # union of device operations in it
    kernels: List[Tuple[str, float]]  # (name, seconds) per device operation
    gaps: Dict[str, Tuple[float, int, float]]  # label -> (s, count, max s)
    steps: List[dict]                # the stretch's batches, as counted

    def seconds(self, patterns) -> float:
        return sum(s for n, s in self.kernels
                   if any(p in n for p in patterns))

    def count(self, pattern: str) -> int:
        return sum(1 for n, _ in self.kernels if pattern in n)

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for n, s in self.kernels:
            by_name[n] += s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[f"{k} ({c} gaps, longest {m * 1e3:.3f} ms)",
                               s] for k, (s, c, m) in gaps]}


class Stretch:
    """``start()`` at a step boundary, ``stop(steps)`` once the stretch's
    work is done and synchronised -> ``Trace``."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.rf = None

    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _spins(self) -> None:
        import torch
        if self.device.type == "cuda":
            for _ in range(GUARDS):
                torch.cuda._sleep(GUARD_CYCLES)
        self._sync()

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def prime(self) -> None:
        """A first, empty capture in set-up: the profiler's one-time start
        (seconds) stays out of the window."""
        prof = self._profiler()
        prof.start()
        self._spins()
        prof.stop()

    def start(self) -> None:
        from torch.autograd.profiler import record_function
        self._sync()
        self.prof = self._profiler()
        self.prof.start()
        self._spins()
        self.rf = record_function(STRETCH)
        self.rf.__enter__()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self, steps: List[dict]) -> Trace:
        self.rf.__exit__(None, None, None)
        self._spins()
        self.prof.stop()
        return read(_events(self.prof), steps)


def _events(prof) -> List[tuple]:
    """(name, on_device, is_annotation, start_s, end_s) of every event."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            t0, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        else:
            t0, dur = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        annotation = (ev.is_user_annotation() if hasattr(
            ev, "is_user_annotation") else ev.name().startswith("bench."))
        out.append((ev.name(), ev.device_type() == cuda,
                    annotation or ev.name().startswith("bench."), t0,
                    t0 + dur))
    return out


def read(events: List[tuple], steps: List[dict]) -> Optional[Trace]:
    """The stretch's numbers from its events (``_events``' tuples)."""
    stretch = [(a, b) for n, dev, _, a, b in events
               if n == STRETCH and not dev]
    if not stretch:
        return None
    s0, s1 = stretch[0]
    ops = sorted((a, b, n) for n, dev, ann, a, b in events
                 if dev and not ann and GUARD_KERNEL not in n
                 and b > s0 and a < s1)
    host = [(n[len("bench."):], a, b) for n, dev, _, a, b in events
            if not dev and n.startswith("bench.") and n != STRETCH]
    busy, gaps, cur = 0.0, defaultdict(lambda: [0.0, 0, 0.0]), s0
    for a, b, _ in ops:
        a, b = max(a, s0), min(b, s1)
        if a > cur:
            _gap(gaps, host, cur, a)
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if s1 > cur:
        _gap(gaps, host, cur, s1)
    return Trace(window_s=s1 - s0, busy_s=busy,
                 kernels=[(n, b - a) for a, b, n in ops],
                 gaps={k: tuple(v) for k, v in gaps.items()}, steps=steps)


def _gap(gaps, host, a: float, b: float) -> None:
    length = b - a
    label = "between_kernels"
    if length >= SHORT_GAP_S:
        best, label = 0.0, "other"
        for name, h0, h1 in host:
            overlap = min(b, h1) - max(a, h0)
            if overlap > best:
                best, label = overlap, name
    g = gaps[label]
    g[0] += length
    g[1] += 1
    g[2] = max(g[2], length)
