"""Spans and counters of the prover, kept in memory.

`enable()` switches tracing on, `disable()` off (the default).  Off,
`span()` returns one shared no-op object and the kernel wrappers time
nothing: a flag test a call.  On, every closed span is kept (the last
`KEEP`, until `clear()`), with its name, id, parent id, request id (its
root's id, so the spans of one proof share it), start and end, attrs, a
`failed` mark where an exception closed it, and the deltas over it of
the registered counters (`register`) and of `wait_ns`.  Spans nest on a
per-thread stack.  A span never synchronises the device.

Stamps are `time.perf_counter_ns()` plus an offset read at `enable()`:
nanoseconds of the Unix clock, the clock of torch.profiler's events.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

ON = False
KEEP = 4096
wait_ns = 0  # host time blocked on device-to-host reads (`wait()`)

_offset = 0
_spans: deque = deque(maxlen=KEEP)
_counted: dict = {}  # name -> (wrapper, its counter attributes)
_ids = itertools.count(1)
_tls = threading.local()


def enable():
    global ON, _offset
    _offset = time.time_ns() - time.perf_counter_ns()
    ON = True


def disable():
    global ON
    ON = False


def now_ns() -> int:
    return time.perf_counter_ns() + _offset


def register(fn, *attrs: str):
    """Spans carry the deltas of `fn`'s integer counters `attrs`, under
    `<fn.__name__>.<attr>`; an attribute `fn` lacks starts at 0."""
    for a in attrs:
        if not hasattr(fn, a):
            setattr(fn, a, 0)
    _counted[fn.__name__] = (fn, attrs)


def counters() -> dict:
    out = {"wait_ns": wait_ns}
    for name, (fn, attrs) in _counted.items():
        for a in attrs:
            out[f"{name}.{a}"] = getattr(fn, a)
    return out


def spans() -> list:
    return list(_spans)


def clear():
    _spans.clear()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns",
                 "end_ns", "failed", "counters", "_base")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.request = up.request if up else self.id
        self._base = counters()
        stack.append(self)
        self.start_ns = now_ns()
        return self

    def __exit__(self, typ, exc, tb):
        self.end_ns = now_ns()
        self.failed = typ is not None
        self.counters = {k: v - self._base.get(k, 0)
                         for k, v in counters().items()}
        _stack().remove(self)
        _spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def span(name: str, **attrs):
    return Span(name, attrs) if ON else _NOOP


class _Wait:
    __slots__ = ("t0",)

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        global wait_ns
        wait_ns += time.perf_counter_ns() - self.t0
        return False


def wait():
    """Times a device-to-host read into `wait_ns` (tracing on)."""
    return _Wait() if ON else _NOOP
