"""Seconds of the program's synthesis (trace/, gadgets/, circuits/): the
benchmark's span around the circuit kind's `synthesize`.  Host clock."""


def read(run):
    return run.spans.get("synth")
