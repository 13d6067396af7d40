"""Set-up spans of a run (the pattern of scripts/prove_voter_torch.py's
`Stage`, kept here so that a change to the program cannot move it): each
span synchronises the device, then reads the host clock, at both ends."""

from __future__ import annotations

import time
from contextlib import contextmanager


class Spans:
    def __init__(self, torch, cuda: bool):
        self.torch = torch
        self.cuda = cuda
        self.seconds: dict[str, float] = {}

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    @contextmanager
    def span(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
