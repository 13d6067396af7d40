"""Circuit kinds, found by the `circuit` name of a configuration: each
`<kind>.py` holds `make_inputs(config, seed)` (the benchmark's inputs,
from the seed alone) and `synthesize(config, inputs)`, which runs the
program's synthesis and returns its Context and public instances."""
