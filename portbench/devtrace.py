"""Reading torch.profiler's record of a window: the device's operations by
name, the seconds in which any ran (the union of their intervals, the
busy-share arithmetic of chip_smoke.py's profiled prove, kept here), and
the idle gaps named by what the host was inside at the time."""

from __future__ import annotations

# gaps shorter than this are launch spacing, not idleness worth naming
GAP_S = 20e-6


def _union_s(intervals: list) -> float:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def _gaps(intervals: list, t0: int, t1: int) -> list:
    out, end = [], t0
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if t1 > end:
        out.append((end, t1))
    return out


def _host_at(host: list, starts: list, t: int) -> str:
    """The innermost host operation running at time t, or, where none
    runs (Python between operations), the last one to have started."""
    import bisect

    best = None
    i = bisect.bisect_right(starts, t)
    # host operations nest; scan back over those that started before t
    for s, e, name in reversed(host[max(0, i - 64) : i]):
        if s <= t < e and (best is None or e - s < best[0]):
            best = (e - s, name)
    if best:
        return best[1]
    return f"python after {host[i - 1][2]}" if i else "python"


def read(prof, t0_ns: int, t1_ns: int) -> dict:
    """{'ops': {name: [count, seconds]}, 'busy_s', 'idle': {host name:
    seconds}} over [t0_ns, t1_ns] of the profiler's clock; 'ops' is empty
    and busy_s 0 when the profiler saw no device activity."""
    from torch.autograd import DeviceType

    ops, dev, host = {}, [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        d = e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            c = ops.setdefault(e.name(), [0, 0.0])
            c[0] += 1
            c[1] += d / 1e9
            dev.append((s, s + d))
        elif d > 0:
            host.append((s, s + d, e.name()))
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    if dev:
        lo = min(t0_ns, min(s for s, _ in dev))
        hi = max(t1_ns, max(e for _, e in dev))
        for a, b in _gaps(dev, lo, hi):
            if (b - a) / 1e9 >= GAP_S:
                name = _host_at(host, starts, (a + b) // 2)
                idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    return {"ops": ops, "busy_s": _union_s(dev), "idle": idle}


def kernel_name(op: str) -> str:
    """`void name<...>(args)` or `name(args)` -> name."""
    s = op[5:] if op.startswith("void ") else op
    return s.split("(")[0].split("<")[0].strip()


def ms_per_proof(run, chosen) -> float | None:
    """Device milliseconds a proof in the operations whose name satisfies
    `chosen`; None where the trace holds no device operation."""
    if run.device != "cuda" or not run.ops or not run.proofs:
        return None
    return 1e3 * sum(v[1] for n, v in run.ops.items() if chosen(n)) / run.proofs
