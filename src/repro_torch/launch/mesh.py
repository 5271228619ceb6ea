"""Meshes and local ranks (``repro/launch/mesh.py``).

* :func:`make_mesh` — a small local mesh for the sharded serving engine:
  its shape, axis names and one device per position (positions may share
  a device: on one card every position is ``cuda:0``).
* :func:`mesh_backends` — the registered backends the mesh plan runs
  (every ``CellBackend``: all but ``std``).
* :func:`spawn_local` — the port's counterpart of the reference's
  simulated host devices: N local ranks, started with the ``spawn``
  method, each in a ``torch.distributed`` world of N (gloo, file
  rendezvous unless given one), calling one function. A training mesh is
  such a world, one rank per cell (``core.distributed``).
* :func:`init_from_env` — a world from torchrun's ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` (NCCL on the rank's own card).
* :func:`make_production_mesh` — the dry-run's production meshes,
  16 x 16 over ``(data, model)`` or 2 x 16 x 16 over ``(pod, data,
  model)``, as an :class:`AbstractMesh` (sizes and names, no devices: the
  counterpart of the reference's ``abstract_mesh``, for spec math), and
  :func:`fake_world` — a ``DeviceMesh`` of any such shape in one process,
  over a ``"fake"`` process group whose collectives move nothing (this
  process is rank 0), for the dry-run's traces.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import os
import tempfile
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A mesh of one process: ``devices`` holds one device per position,
    row-major over ``axis_names``."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` at position 0 of the other axes."""
        i = self.axis_names.index(axis)
        stride = 1
        for n in self.sizes[i + 1:]:
            stride *= n
        return tuple(self.devices[j * stride] for j in range(self.sizes[i]))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> LocalMesh:
    """A local mesh of ``shape`` over ``axes``; ``devices`` (one per
    position, default all ``cuda``) may repeat a device."""
    shape = tuple(int(x) for x in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    n = 1
    for x in shape:
        n *= x
    if devices is None:
        from repro_torch.device import resolve_device

        devices = [resolve_device(None)] * n
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got "
                         f"{len(devices)}")
    return LocalMesh(axis_names=axes, sizes=shape, devices=devices)


def mesh_backends() -> Tuple[str, ...]:
    """Registered sampler backends the mesh plan can run (those with a
    ``cell_sweep``): every algorithm except the textbook ``std``."""
    from repro_torch import algorithms

    return tuple(n for n in algorithms.registered()
                 if algorithms.get(n).supports_shard_map)


def _resolve(target: str) -> Callable:
    """``"package.module:function"`` or ``"/path/to/file.py:function"``."""
    mod_name, _, fn_name = target.rpartition(":")
    if not mod_name or not fn_name:
        raise ValueError(f"target {target!r} is not 'module:function'")
    if mod_name.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"_rank_target_{abs(hash(mod_name))}", mod_name)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod_name)
    return getattr(module, fn_name)


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               target: str, args: tuple) -> None:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    # each rank takes its share of the host's cores: N ranks of a full
    # thread pool each oversubscribe the host many times over
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        _resolve(target)(*args)
    finally:
        dist.destroy_process_group()


def spawn_local(target: str, nprocs: int, args: tuple = (),
                backend: str = "gloo",
                init_method: Optional[str] = None) -> None:
    """Run ``target(*args)`` in ``nprocs`` local ranks of one
    ``torch.distributed`` world and wait for all of them; a rank that
    raises makes this raise. ``target`` is ``"module:function"`` or
    ``"file.py:function"`` (resolved in each rank, so it need not
    pickle). ``init_method`` defaults to a file rendezvous in a fresh
    temporary directory."""
    import torch.multiprocessing as mp

    if nprocs < 1:
        raise ValueError(f"need at least one rank, got {nprocs}")
    with tempfile.TemporaryDirectory(prefix="mesh_rdv_") as tmp:
        init = init_method or f"file://{os.path.join(tmp, 'rdv')}"
        mp.start_processes(_rank_main,
                           args=(nprocs, backend, init, target, tuple(args)),
                           nprocs=nprocs, join=True, start_method="spawn")


def init_from_env(device: str = "cuda") -> Optional[torch.device]:
    """Join the world torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL on card
    ``LOCAL_RANK`` for ``device="cuda"``, gloo for the CPU. Returns the
    rank's device, or None when no such world is described. NCCL missing
    on a card raises."""
    import torch.distributed as dist

    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return None
    if device == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this torch build")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
        return dev
    dist.init_process_group("gloo")
    return torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, no devices (spec math only)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for x in self.sizes:
            n *= x
        return n


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """16 x 16 = 256 devices per pod; ``multi_pod`` adds a leading 2-pod
    axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh as sizes and names (the reference's
    ``make_production_mesh``, whose devices no machine here has)."""
    return AbstractMesh(*production_shape(multi_pod)[::-1])


@contextlib.contextmanager
def fake_world(shape: Sequence[int], axes: Sequence[str],
               device: str = "cuda") -> Iterator:
    """A ``DeviceMesh`` of ``shape`` over ``axes`` for one process acting
    as rank 0 of a ``"fake"`` process group of ``prod(shape)`` ranks: its
    collectives return at once and move nothing, so a DTensor program
    runs rank 0's share of the work. ``device`` is the mesh's device type
    (``cuda`` needs a card). The world is global state: it is created on
    entry and destroyed on exit, and entering while another process group
    is live raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    n = 1
    for x in shape:
        n *= int(x)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh(device, tuple(int(x) for x in shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()
