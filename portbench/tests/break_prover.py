"""Run portbench/run.py's main with the timed path broken underneath
(the CPU tests run this in a child process, so the run's own check of
its loaded modules sees only the run):

    python portbench/tests/break_prover.py <fault> <run.py arguments...>

stale: after its first answer (the warm-up's), the prover returns that
answer again;
altered: one byte in the middle of each answer is changed where the
prover produces it."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import run  # noqa: E402


def main():
    fault, argv = sys.argv[1], sys.argv[2:]
    honest = run.Setup.prove
    first = []

    def stale(self, rng):
        if not first:
            first.append(honest(self, rng))
        time.sleep(0.05)
        return first[0]

    def altered(self, rng):
        p = bytearray(honest(self, rng))
        p[len(p) // 2] ^= 0x01
        return bytes(p)

    run.Setup.prove = {"stale": stale, "altered": altered}[fault]
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
