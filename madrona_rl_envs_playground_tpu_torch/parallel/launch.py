"""Multi-process launch.

Counterpart of ``madrona_rl_envs_playground_tpu/parallel/launch.py``.  One
process a rank, the same program everywhere:

    from madrona_rl_envs_playground_tpu_torch.parallel import launch, make_mesh
    launch.initialize()            # torch.distributed, from torchrun's variables
    mesh = make_mesh()             # every rank of the group
    trainer = SelfPlayPPO(env, num_envs, cfg, mesh=mesh)

    torchrun --nproc_per_node=4 scripts/torch_selfplay_train.py ...

Each rank holds its rows of the env batch; the gradient all-reduce of the
update is the only collective of a step of training (``parallel/mesh.py``).
A single process needs none of this: ``initialize`` returns False and the
same script runs unchanged.  ``spawn`` starts the ranks of a group from one
process (the tests' 4 CPU ranks, two ranks sharing one card).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from .mesh import make_mesh


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               init_method: Optional[str] = None,
               device: DeviceLike = None) -> bool:
    """Join the process group when running more than one process.

    With no arguments, reads torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.  ``init_method`` (for
    example ``file:///tmp/store``, a ``FileStore``) takes the place of the
    address.  The backend is ``nccl`` for CUDA ranks and ``gloo`` for CPU
    ranks (``device``, default the card) unless ``backend`` names one; a
    CUDA rank first selects card ``LOCAL_RANK``.  Returns True when this
    call joined a group, False for a single process or a group joined
    before, as JAX's does."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if dist.is_initialized():
        return False
    if init_method is None:
        if coordinator_address is None or not num_processes or num_processes < 2:
            return False  # a single process
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs the number of processes and this process's id "
                         "(WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or dev.index or 0)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return True


def is_primary() -> bool:
    """Rank 0 of the group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _spawned(rank: int, fn: Callable, world_size: int, args: Tuple, store_dir: str,
             backend: Optional[str], device: DeviceLike, threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    initialize(num_processes=world_size, process_id=rank, backend=backend,
               init_method=f"file://{os.path.join(store_dir, 'store')}", device=device)
    try:
        result = fn(make_mesh(device=device), *args)
        torch.save(result, os.path.join(store_dir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Tuple = (), *, store_dir: str,
          backend: Optional[str] = None, device: DeviceLike = None,
          timeout_s: float = 600.0, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes, ranks of one
    group joined through a ``FileStore`` in the empty directory
    ``store_dir`` (no TCP port, so that concurrent groups on one machine do
    not collide), each with a mesh of all of them on ``device`` (default
    the card; two ranks may share one card on ``gloo``).  ``fn`` must be
    importable by name and return tensors, numbers, strings, or lists and
    dicts of them.  Returns the results in rank order.  Raises the first
    rank's exception, and TimeoutError, killing every rank, when they have
    not all ended within ``timeout_s``; no process outlives the call."""
    ctx = torch.multiprocessing.start_processes(
        _spawned, args=(fn, world_size, tuple(args), store_dir, backend, device, threads),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} did not end within "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=60)
    return [torch.load(os.path.join(store_dir, f"result_{r}.pt"), weights_only=True)
            for r in range(world_size)]
