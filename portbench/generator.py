"""The one generator of requests, driven by a traffic file
(traffic/<name>.json):

  {"loop": "closed", "clients": 1, "warmup": 1}

A closed loop: each client sends its next request once the last one has
been answered.  A request here is one proof on the resident key, with
blinding drawn from its own random source, seeded from the run's seed and
the request's number, so one seed gives the same requests in every run.
Requests start while less than `seconds` has passed since the first
started; the window ends when the last one ends.  `warmup` requests
before the window belong to set-up.
"""

from __future__ import annotations

import random
import sys
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    answers: list = field(default_factory=list)
    durations: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    start: float = 0.0
    end: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start


def request_rng(seed: int, i: int, phase: str = "window") -> random.Random:
    return random.Random(f"{phase}:{seed}:{i}")


def check_traffic(traffic: dict):
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"unsupported traffic {traffic}: only a closed "
                         "loop of one client")


def warm_up(traffic: dict, call, seed: int, sync):
    for i in range(traffic.get("warmup", 0)):
        call(request_rng(seed, i, "warmup"))
        sync()


def closed_loop(traffic: dict, call, seed: int, seconds: float,
                sync) -> Window:
    check_traffic(traffic)
    w = Window()
    w.start = time.perf_counter()
    while (t := time.perf_counter()) - w.start < seconds:
        w.attempted += 1
        try:
            out = call(request_rng(seed, w.attempted - 1))
            sync()
        except Exception:  # a request that fails ends the window
            traceback.print_exc(file=sys.stderr)
            w.failed += 1
            break
        w.answers.append(out)
        w.durations.append(time.perf_counter() - t)
    w.end = time.perf_counter()
    return w
