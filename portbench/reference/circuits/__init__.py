"""Each circuit kind's public instances, worked out from the benchmark's
inputs alone: `<kind>.py` holds `expected_instances(config, inputs)`."""
