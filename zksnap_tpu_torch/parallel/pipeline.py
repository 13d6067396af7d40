# Copy of zksnap_tpu/parallel/pipeline.py: jax-free; goes once zksnap_tpu imports jax lazily.
"""Cross-round pipeline parallelism (SURVEY.md section 2.3, P4).

The reference proves recursion rounds strictly sequentially
(aggregator/src/wrapper.rs:884-901 -- single process, every round is
witness-synth -> prove -> carry).  On TPU the host and the chip are
independent engines: trace synthesis (pure-Python circuit building,
tens of seconds per round at production width) is host-bound, while
`prove()` is device-bound and releases the GIL inside compiled XLA
executions.  So round r+1's child witnesses can be synthesized WHILE
round r's proofs occupy the chip.

`Lookahead` is the one-slot pipeline primitive: it iterates `fn(0..n)`
with the next call always running on a worker thread while the consumer
processes the current value.  Used by scripts/prove_wrapper_tpu.py to
overlap child-circuit synthesis with wrapper proving.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")


class Lookahead:
    """Iterate ``fn(i) for i in range(n)`` with one-step lookahead.

    ``fn(i+1)`` runs on a worker thread while the consumer processes
    ``fn(i)``; exceptions surface at the consuming ``next()`` call.
    Exactly one call is in flight at a time, so ``fn`` may hold large
    intermediate state without doubling peak memory beyond one round.
    """

    def __init__(self, fn: Callable[[int], T], n: int):
        self._fn = fn
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[T]:
        if self._n <= 0:
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._fn, 0)
            for i in range(self._n):
                val = fut.result()
                if i + 1 < self._n:
                    fut = ex.submit(self._fn, i + 1)
                yield val
