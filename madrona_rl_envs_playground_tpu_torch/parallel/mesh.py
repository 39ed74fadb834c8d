"""Env-axis data parallelism: the mesh, sharding and the collectives.

Counterpart of ``madrona_rl_envs_playground_tpu/parallel/mesh.py``.  JAX
runs one process over a global array whose env axis is sharded across
chips; here each rank is a process (``parallel/launch.py``) and a ``Mesh``
is its view of the group:

* rank ``r`` of ``R`` holds world rows ``[r N / R, (r + 1) N / R)`` of the
  global batch of ``N`` worlds (``Mesh.rows``); constructors take the
  global ``N``;
* parameters and optimizer state are replicated, broadcast from rank 0 at
  construction (``put_selfplay_state``, ``Mesh.broadcast_module_``);
* every gradient is summed across ranks before the clip and the Adam step
  (``Mesh.all_reduce_grads``), so every rank takes the same step; the
  losses are built so that their sum over the ranks is the loss of the
  whole batch (``train/optim.py``'s ``GlobalMean``).

A mesh of one rank without a process group (``make_mesh()`` in a single
process) reduces nothing: its collectives return their input.  Ranks of the
``gloo`` backend whose tensors lie on the card (two ranks sharing one card,
which NCCL refuses) stage each collective through host memory.

``COLLECTIVES`` counts, by what was reduced, the calls and the bytes each
rank hands to a collective (an all-gather: the bytes it receives), for
``scripts/torch_multihost_projection.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

ENV_AXIS = "env"

# "<collective>/<what>" -> {"calls": n, "bytes": b}
COLLECTIVES: Dict[str, Dict[str, int]] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _count(kind: str, what: str, nbytes: int) -> None:
    c = COLLECTIVES.setdefault(f"{kind}/{what}", {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh over the env axis.

    ``group`` is the process group (None: the default group, or no group
    at all when ``size`` is 1 and none was joined); ``device`` is where
    this rank's tensors live."""

    size: int
    rank: int
    device: torch.device
    group: Any = None
    backend: Optional[str] = None
    axis_names: Tuple[str, ...] = (ENV_AXIS,)

    # ---- rows ----------------------------------------------------------
    def local_size(self, n: int) -> int:
        if n % self.size:
            raise ValueError(f"{n} worlds do not split evenly over {self.size} ranks")
        return n // self.size

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        k = self.local_size(n)
        return slice(self.rank * k, (self.rank + 1) * k)

    # ---- collectives ---------------------------------------------------
    @property
    def _solo(self) -> bool:
        return self.size == 1 and not dist.is_initialized()

    @property
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor, what: str = "value") -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor; ``t`` untouched)."""
        _count("all_reduce", what, _nbytes(t))
        if self._solo:
            return t.clone()
        buf = t.detach().to("cpu", copy=True) if self._staged else t.detach().clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int = 0, what: str = "value") -> torch.Tensor:
        """Every rank's ``t``, concatenated in rank order along ``dim``."""
        _count("all_gather", what, _nbytes(t) * self.size)
        if self._solo:
            return t.clone()
        src = t.detach().cpu() if self._staged else t.detach()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim).to(t.device)

    def exclusive_scan(self, count: torch.Tensor, what: str = "episodes"):
        """(the sum of ``count`` over the ranks before this one, the sum over
        all ranks) for an integer scalar: one all-gather of a scalar."""
        counts = self.all_gather(count.reshape(1), what=what)
        return counts[:self.rank].sum(), counts.sum()

    def broadcast_(self, tensors: Iterable[torch.Tensor], what: str = "params") -> None:
        """Overwrite each tensor with rank 0's, in place."""
        for t in tensors:
            _count("broadcast", what, _nbytes(t))
            if self._solo:
                continue
            if not self._staged:
                dist.broadcast(t.detach(), src=0, group=self.group)
                continue
            buf = t.detach().cpu()
            dist.broadcast(buf, src=0, group=self.group)
            with torch.no_grad():
                t.copy_(buf)

    def broadcast_module_(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        self.broadcast_(list(module.parameters()) + list(module.buffers()))

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` (any picklable value) on every rank."""
        if self._solo:
            return obj
        box = [obj]
        # the first ranks of the group form the mesh, so its rank 0 is the
        # group's; NCCL moves the pickled bytes through the card
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Sum every gradient over the ranks, in place, as one flat buffer."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = self.all_reduce(flat, what="grad")
        off = 0
        with torch.no_grad():
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def barrier(self) -> None:
        if not self._solo:
            dist.barrier(group=self.group)


def make_mesh(num_devices: Optional[int] = None, device: DeviceLike = None) -> Optional[Mesh]:
    """A 1-D mesh over the env axis: the first ``num_devices`` ranks of the
    group (default all of them).  Every rank must call it; a rank outside
    the mesh gets None.  Without a process group, a mesh of this one
    process.  ``device`` (default the card, ``cuda:<current device>``) is
    where this rank's tensors live."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f"a mesh of {num_devices} ranks needs a process group "
                             "(parallel.launch.initialize)")
        return Mesh(size=1, rank=0, device=dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if num_devices is None else num_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(size=n, rank=rank, device=dev, group=group, backend=dist.get_backend())


def batch_sharding(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The placement of an env-axis leaf: this rank's rows, on its device."""
    return lambda x: x[mesh.rows(x.shape[0])].to(mesh.device)


def replicated(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The placement of a replicated leaf: the whole of it, on the rank's device."""
    return lambda x: x.to(mesh.device)


def shard_batch_pytree(tree, mesh: Mesh):
    """Every ``[N, ...]`` tensor of ``tree`` (dataclasses, dicts, tuples
    and lists of tensors) cut to this rank's rows, and scalar leaves (the
    episode counter) and leaves whose first axis does not split evenly
    replicated, as JAX's ``shard_batch_pytree`` places them."""
    bs, rep = batch_sharding(mesh), replicated(mesh)

    def put(x):
        if isinstance(x, torch.Tensor):
            return bs(x) if x.dim() >= 1 and x.shape[0] % mesh.size == 0 else rep(x)
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: put(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        return x

    return put(tree)


def gather_batch_pytree(tree, mesh: Mesh):
    """The inverse of ``shard_batch_pytree`` for a batch of ``n`` rows a
    rank: every ``[n, ...]`` tensor gathered from the ranks in rank order,
    scalar leaves kept.  Every rank must call it."""

    def get(x):
        if isinstance(x, torch.Tensor):
            return mesh.all_gather(x, what="state") if x.dim() >= 1 else x
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: get(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: get(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(get(v) for v in x)
        return x

    return get(tree)


def put_selfplay_state(state: dict, mesh: Mesh) -> dict:
    """A ``SelfPlayPPO`` state on the mesh: ``bstate`` and ``out`` cut to
    this rank's rows.  (JAX's state also holds the parameters; here the
    network holds them, and ``Mesh.broadcast_module_`` replicates it.)"""
    return {k: shard_batch_pytree(v, mesh) if k in ("bstate", "out") else v
            for k, v in state.items()}
