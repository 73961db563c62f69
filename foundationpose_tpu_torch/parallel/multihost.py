"""Multi-process runtime initialisation and the global mesh, on torch.distributed.

Counterpart of foundationpose_tpu/parallel/multihost.py. One process per
device: ``initialize`` brings up the default process group, either from an
explicit coordinator (``tcp://<coordinator_address>``, the world size and this
process's rank) or from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). A launch with neither stays
single-process, as the JAX package's does. The backend follows the device the
caller names: ``nccl`` for cuda, ``gloo`` for the CPU; ``backend=`` overrides
it (two processes sharing one card need ``gloo``: NCCL refuses two ranks on
one device).

    from foundationpose_tpu_torch.parallel import multihost
    multihost.initialize("localhost:29500", num_processes=2, process_id=rank,
                         device="cpu")
    mesh = multihost.make_global_mesh(("batch",))
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from foundationpose_tpu_torch import resolve_device

_device = None  # the device this process's tensors live on, set by ``initialize``


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None, device=None,
               backend: str | None = None):
    """Bring up the process group (idempotent). ``device=None`` means cuda:
    the card ``local_device_ids[0]`` (default: the local rank, modulo the
    cards present), over nccl unless ``backend`` says otherwise."""
    global _device
    if dist.is_initialized():
        return
    env_ready = all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"))
    if coordinator_address is None and not env_ready:
        logging.info("multihost.initialize: no coordinator and no launcher environment; "
                     "running single-process")
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                    rank=int(process_id))
    else:
        init = dict(init_method="env://")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if local_device_ids is not None:
            index = int(list(local_device_ids)[0])
        else:
            local = int(os.environ.get("LOCAL_RANK", init.get("rank", os.environ.get("RANK", 0))))
            index = local % torch.cuda.device_count()
        dev = torch.device("cuda", index)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), **init)
    _device = dev


def local_device():
    """The device ``initialize`` gave this process (cuda when it ran none)."""
    return _device if _device is not None else resolve_device(None)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that should write checkpoints and logs."""
    return process_index() == 0


def make_global_mesh(axis_names=("batch",), shape=None):
    """Mesh over every process of the job (one device each), on the device
    ``initialize`` chose."""
    from foundationpose_tpu_torch.parallel.mesh import make_device_mesh

    return make_device_mesh(process_count(), axis_names=axis_names, shape=shape,
                            device=local_device())


def sync_hosts(name: str = "barrier"):
    """Barrier across processes (no-op single-process)."""
    if process_count() > 1:
        dist.barrier()


def broadcast_from_primary(tree):
    """Process 0's picklable object (configs, seeds, numpy arrays) on every
    process (no-op single-process)."""
    if process_count() <= 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]
