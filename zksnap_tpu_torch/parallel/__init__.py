"""Parallelism across rounds and devices (port of zksnap_tpu/parallel/).

  * `distributed.py` -- `Mesh` / `make_mesh` (named axes over a list of
    torch devices, one controller; a device may appear more than once,
    a virtual mesh), `initialize` (torch.distributed from the JAX
    package's env contract), `ProtocolMesh`, `protocol_mesh`,
    `chip_submesh` and `scaling_efficiency`;
  * `sharded.py` -- `sharded_msm`; the prover's sharded commit and the
    four-step NTT (poly/ntt.py) run under `prover.poly_device.prover_mesh`;
  * `batch_witness.py` and `pipeline.py` -- host copies of the JAX
    package's process pool of witness syntheses and its round pipeline.
"""

from .distributed import (
    Mesh,
    ProtocolMesh,
    chip_submesh,
    initialize,
    make_mesh,
    protocol_mesh,
    scaling_efficiency,
)
from .sharded import sharded_msm

__all__ = [
    "Mesh",
    "ProtocolMesh",
    "chip_submesh",
    "initialize",
    "make_mesh",
    "protocol_mesh",
    "scaling_efficiency",
    "sharded_msm",
]
