"""Device meshes, process bootstrap and a scaling-efficiency harness
(PyTorch port of zksnap_tpu/parallel/distributed.py).

The JAX package drives a mesh of devices from one controller: its
sharded kernels (parallel/sharded.py, poly/ntt.py's four-step NTT) run
one program per device of a mesh axis, and its tests make that mesh from
8 virtual CPU devices.  The port keeps the single controller.  A `Mesh`
is a nested list of `torch.device`s with named axes; the sharded code
runs each shard's work on that shard's device and moves data between
the devices of the mesh by copies.  A mesh may name one device more
than once (a virtual mesh: `[torch.device("cuda", 0)] * 4`), so every
sharded line runs through the real kernels on one card; the same code
runs one shard a card on a machine with several.

`initialize()` brings up `torch.distributed` from the JAX package's env
contract (NCCL for the card, gloo for the CPU), the one piece that spans
processes in both packages; nothing in the prover needs a process group.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import torch


class Mesh:
    """Devices on named axes, held as a nested list (one level an axis).

    `shape` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        sizes, level = [], devices
        for _ in self.axis_names:
            sizes.append(len(level))
            level = level[0]
        self.shape = dict(zip(self.axis_names, sizes))

    def device_list(self) -> list:
        """Every device of the mesh, in order (the axes flattened)."""
        flat = self.devices
        for _ in self.axis_names[1:]:
            flat = [d for row in flat for d in row]
        return list(flat)

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis` of a mesh whose other axes have size 1
        (the 1-D meshes the sharded kernels take)."""
        if any(size != 1 for name, size in self.shape.items()
               if name != axis):
            raise ValueError(f"mesh {self.shape} is not one-dimensional "
                             f"along {axis!r}")
        return self.device_list()

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list()]})"


def _visible_devices(device) -> list:
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def _concrete(dev: torch.device) -> torch.device:
    """A CUDA device with its index (`cuda` is the current card), so that
    two names of one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape, axis_names, devices=None, device="cuda") -> Mesh:
    """A mesh of `shape` over the first prod(shape) of `devices` (default:
    the visible devices of `device`'s type).  `devices` may repeat a
    device: a virtual mesh."""
    devices = list(devices) if devices is not None else \
        _visible_devices(device)
    shape = tuple(shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    size = math.prod(shape)
    if size > len(devices):
        raise ValueError(f"a mesh of {shape} needs {size} devices, "
                         f"{len(devices)} given")
    nested = [_concrete(torch.device(d)) for d in devices[:size]]
    for dim in reversed(shape[1:]):
        nested = [nested[i:i + dim] for i in range(0, len(nested), dim)]
    return Mesh(nested, axis_names)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> bool:
    """Bring up the torch.distributed process group when multi-process
    configuration is present (args > env > nothing).  Returns True iff
    distributed mode is active.

    Env contract (the JAX package's):
      ZKSNAP_COORDINATOR   host:port of process 0
      ZKSNAP_NUM_PROCESSES total process count
      ZKSNAP_PROCESS_ID    this process's rank
    The backend is NCCL for `device="cuda"` (one rank a card) and gloo for
    the CPU.  With no configuration no process group is started."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("ZKSNAP_COORDINATOR")
    if num_processes is None and "ZKSNAP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ZKSNAP_NUM_PROCESSES"])
    if process_id is None and "ZKSNAP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ZKSNAP_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs a coordinator, a process count "
                         "and a process id")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


@dataclass
class ProtocolMesh:
    """The framework's standard 2-axis mesh.

    axis "host": data parallelism (independent proofs / witness batches).
    axis "chip": the sharded kernels (four-step NTT exchange, MSM
    partials)."""

    mesh: Mesh
    n_hosts: int
    chips_per_host: int


def protocol_mesh(chips_per_host: int | None = None, devices=None,
                  device="cuda") -> ProtocolMesh:
    """The ("host", "chip") mesh over `devices` (default: the visible
    devices of `device`'s type).  With one process and chips_per_host
    below the device count, the host axis folds the local devices, as in
    the JAX package."""
    import torch.distributed as dist

    devices = list(devices) if devices is not None else \
        _visible_devices(device)
    n_proc = (dist.get_world_size()
              if dist.is_available() and dist.is_initialized() else 1)
    total = len(devices)
    if chips_per_host is None:
        chips_per_host = total // n_proc
    n_hosts = total // chips_per_host
    mesh = make_mesh((n_hosts, chips_per_host), ("host", "chip"), devices)
    return ProtocolMesh(mesh=mesh, n_hosts=n_hosts,
                        chips_per_host=chips_per_host)


def chip_submesh(pm: ProtocolMesh) -> Mesh:
    """1-D ("x",) mesh over this configuration's chip axis -- the shape
    parallel/sharded.py and poly/ntt.py take."""
    return make_mesh((pm.n_hosts * pm.chips_per_host,), ("x",),
                     pm.mesh.device_list())


# ---------------------------------------------------------------------------
# Scaling-efficiency harness
# ---------------------------------------------------------------------------

def scaling_efficiency(work_fn, sizes: list[int], mesh_for) -> list[dict]:
    """Measure strong-scaling efficiency of `work_fn(n_chips, mesh)`.

    `work_fn` must run ONE fixed-size workload sharded over the given
    mesh and block until done; `mesh_for(n)` builds an n-chip mesh.
    Returns [{n, seconds, speedup, efficiency}] with n=sizes[0] as the
    baseline.  Pure measurement -- callers print / persist.
    """
    out = []
    base = None
    for n in sizes:
        mesh = mesh_for(n)
        work_fn(n, mesh)          # warm-up
        t0 = time.time()
        work_fn(n, mesh)
        dt = time.time() - t0
        if base is None:
            base = (sizes[0], dt)
        out.append({
            "n": n,
            "seconds": dt,
            "speedup": base[1] / dt if dt else float("inf"),
            "efficiency": (base[1] / dt) / (n / base[0]) if dt
                          else float("inf"),
        })
    return out
