"""Process meshes and the collectives the sharded paths use, on torch.distributed.

Counterpart of foundationpose_tpu/parallel/mesh.py. The JAX package lays a
``jax.sharding.Mesh`` over devices and lets XLA place the collectives; here
each process drives one device, a :class:`Mesh` names the processes of the
group along its axes, and the sharded paths call the collectives themselves:

- ``batch`` axis: pose hypotheses (``register``) and BA landmarks; each
  process computes its slice of the leading axis and the slices are gathered
  (``all_gather_rows``) or their partial sums added (``all_sum``).

Without an initialised process group a mesh has one process and every
collective is the identity, so a sharded path runs unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from foundationpose_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of processes, one device each: ``shape[axis]`` is an axis's
    size and ``index(axis)`` this process's coordinate on it. An axis holds
    every process of the default group or one."""

    axis_names: tuple
    sizes: tuple
    coords: tuple
    device: torch.device

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axis="batch"):
        return self.sizes[self.axis_names.index(axis)]

    def index(self, axis="batch"):
        return self.coords[self.axis_names.index(axis)]


def make_device_mesh(n_devices: int | None = None, axis_names=("batch",), shape=None,
                     device=None):
    """Mesh over the processes of the group (the one process when none is
    initialised). ``n_devices`` must be the group's size; ``shape`` defaults
    to all of them on the first axis, and any axis holds either every process
    or one (sub-groups along an axis are not supported). ``device=None``
    means cuda."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh spans every process of the group: n_devices={n}, "
                         f"processes={world}")
    axis_names = tuple(axis_names)
    shape = tuple(shape) if shape is not None else (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not lay out {n} processes on {axis_names}")
    if any(size not in (1, world) for size in shape):
        raise ValueError(f"mesh shape {shape}: an axis holds every process or one")
    coords = tuple(rank if size > 1 else 0 for size in shape)
    return Mesh(axis_names, shape, coords, resolve_device(device))


_default_mesh = None


def get_mesh():
    """Process-wide default mesh: every process on the ``batch`` axis, on the
    device ``multihost.initialize`` chose."""
    global _default_mesh
    if _default_mesh is None:
        from foundationpose_tpu_torch.parallel import multihost

        _default_mesh = make_device_mesh(device=multihost.local_device())
    return _default_mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def shard_batch(mesh: Mesh, tree, axis: str = "batch"):
    """This process's slice of the leading axis of every array of ``tree``,
    on the mesh's device. The caller pads that axis to a multiple of the
    axis size; 0-d leaves are replicated."""
    n, i = mesh.size(axis), mesh.index(axis)

    def take(x):
        x = _as_tensor(x, mesh.device)
        if x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} is not a multiple of the "
                             f"{axis!r} axis size {n}: pad it first")
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return _tree_map(take, tree)


def replicate(mesh: Mesh, tree):
    """Every array of ``tree`` as process 0 of the group holds it, on the
    mesh's device (a broadcast)."""

    def bcast(x):
        x = _as_tensor(x, mesh.device).contiguous()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.broadcast(x, src=0)
        return x

    return _tree_map(bcast, tree)


def all_sum(mesh: Mesh, x, axis: str = "batch"):
    """Sum of ``x`` over the processes of ``axis`` (a new tensor)."""
    if mesh.size(axis) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y


def all_gather_rows(mesh: Mesh, x, axis: str = "batch"):
    """Concatenate every process's ``x`` along the leading axis, in the order
    of the processes' coordinates on ``axis`` (equal shapes everywhere). One
    all_reduce of a zero-filled buffer that holds each slice in its place:
    adding zeros is exact, and both backends take an all_reduce of a tensor on
    either device."""
    n = mesh.size(axis)
    if n == 1:
        return x
    per = x.shape[0]
    buf = torch.zeros((n * per, *x.shape[1:]), dtype=x.dtype, device=x.device)
    i = mesh.index(axis)
    buf[i * per:(i + 1) * per] = x
    return all_sum(mesh, buf, axis)
