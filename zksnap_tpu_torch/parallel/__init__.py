"""Parallelism across rounds and devices (port of zksnap_tpu/parallel/).

Only `pipeline.py` is here so far, a copy of the JAX package's host
thread pool (`Lookahead`), which scripts/prove_wrapper_torch.py uses to
synthesise the next round's child witnesses while the card proves this
round's.
The multi-device modules (`sharded.py`, `distributed.py`,
`batch_witness.py`) are not ported yet.
"""
