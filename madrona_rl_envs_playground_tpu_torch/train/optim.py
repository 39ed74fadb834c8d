"""The trainers' Adam, the gradient clip they put in front of it, and the
means and gradient sums that make an update on a mesh the update of the
whole batch.

Counterpart of ``optax.adam``/``adamw`` behind ``optax.inject_hyperparams``
and ``optax.clip_by_global_norm`` as the JAX trainers chain them, and of
the reductions XLA derives from a sharded batch.  On the card ``adam``
keeps its whole state there, as optax does: the step counts and bias
corrections (``capturable``) and the learning rate, a float32 tensor that
``set_lr`` fills in place, so that a CUDA graph of the update
(``train/graphs.py``) steps it and reads each new rate.  ``update_tensors``
names what an update writes in place, and ``load_optimizer_state_``
restores a saved state into those very tensors.  On a mesh
(``parallel/mesh.py``) each rank holds its rows of the batch:

* a mean is each rank's sum over the **global** count (``GlobalMean``): the
  ranks' shares sum to the mean of the whole batch, and so do their
  gradients;
* ``all_sum`` adds the shares of the metrics over the ranks;
* ``all_reduce_grads`` sums the gradients before ``clip_grad_global_norm_``,
  so that the clip sees the global norm and every rank's Adam step is the
  same.

Without a mesh every function here is the plain single-process arithmetic.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float, eps: float,
         weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam, or AdamW where ``weight_decay`` is set (optax's ``adamw``: every
    parameter decays, scaled by the learning rate).  For parameters on a
    CUDA device with ``capturable=True`` and the learning rate a float32
    tensor there; on the CPU with torch's defaults, a float rate and
    ``capturable=False`` (torch refuses ``capturable`` for CPU
    parameters)."""
    params = list(params)
    dev = params[0].device
    cuda = dev.type == "cuda"
    rate = torch.tensor(lr, dtype=torch.float32, device=dev) if cuda else lr
    if weight_decay:
        return torch.optim.AdamW(params, lr=rate, eps=eps, weight_decay=weight_decay,
                                 capturable=cuda)
    return torch.optim.Adam(params, lr=rate, eps=eps, capturable=cuda)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of every group of ``opt``: a tensor rate filled in
    place (a captured step reads it), a float one replaced."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def update_tensors(modules: Sequence[torch.nn.Module],
                   optimizers: Sequence[torch.optim.Optimizer]) -> List[torch.Tensor]:
    """What an optimizer step of ``modules`` writes in place, in a fixed
    order: every parameter (detached: the same storage) and its gradient
    where it has one, then each optimizer's state tensors (moments and step
    count) by parameter, and its tensor learning rates."""
    out = []
    for m in modules:
        for p in m.parameters():
            out.append(p.detach())
            if p.grad is not None:
                out.append(p.grad)
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                out.extend(v for v in opt.state.get(p, {}).values()
                           if isinstance(v, torch.Tensor))
            if isinstance(group["lr"], torch.Tensor):
                out.append(group["lr"])
    return out


def load_optimizer_state_(opt: torch.optim.Optimizer, saved: dict) -> None:
    """``opt.load_state_dict(saved)`` into ``opt``'s own tensors: where a
    parameter has a state already, its moments and step count are copied
    in place, and every group keeps its ``capturable`` and its tensor
    learning rate (filled with the saved rate), so that a captured step
    goes on reading them.  ``saved`` may come from either device: a step
    count saved on the CPU moves to the card for a ``capturable``
    optimizer, one saved there to the CPU otherwise."""
    own = [(group["capturable"], group["lr"]) for group in opt.param_groups]
    held = {p: dict(st) for p, st in opt.state.items()}
    opt.load_state_dict(saved)
    for group, (capturable, lr) in zip(opt.param_groups, own, strict=True):
        group["capturable"] = capturable
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
        else:
            group["lr"] = float(group["lr"])
        for p in group["params"]:
            st = opt.state.get(p)
            if st is None:
                continue
            if p in held:
                with torch.no_grad():
                    for k, v in st.items():
                        held[p][k].copy_(v)
                opt.state[p] = held[p]
            else:
                st["step"] = st["step"].to(p.device if capturable else "cpu", torch.float32)


def clip_grad_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> None:
    """Scale the gradients of ``params`` in place to a global norm of at
    most ``max_norm``, as optax writes it: ``g / norm * max_norm`` where
    ``norm >= max_norm``, untouched below (``clip_grad_norm_`` adds 1e-6 to
    the norm and scales by ``max_norm / (norm + 1e-6)`` instead)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    with torch.no_grad():
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))


def all_sum(mesh, x: torch.Tensor, what: str = "metrics") -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh``; ``x`` itself without one."""
    return x if mesh is None else mesh.all_reduce(x, what=what)


def all_reduce_grads(mesh, params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the gradients of ``params`` over the ranks (nothing without a mesh)."""
    if mesh is not None:
        mesh.all_reduce_grads(params)


class GlobalMean:
    """Means over the whole batch of a mesh, of tensors shaped like this
    rank's rows.  ``weights`` (for example the active slots) makes it the
    weighted mean, over the global sum of the weights (at least
    ``min_count`` where given); without weights, over the global number of
    elements of a tensor like ``like``.  Calling it on ``x`` returns this
    rank's share, ``sum(x * weights) / count``: summed over the ranks
    (``all_sum``), the mean of the whole batch."""

    def __init__(self, mesh=None, weights: Optional[torch.Tensor] = None,
                 like: Optional[torch.Tensor] = None, min_count: Optional[float] = None):
        self.weights = weights
        if weights is not None:
            n = all_sum(mesh, weights.sum(), what="count")
            self.count = n if min_count is None else torch.clamp(n, min=min_count)
        else:
            self.count = float(like.numel() * (1 if mesh is None else mesh.size))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        total = x.sum() if self.weights is None else (x * self.weights).sum()
        return total / self.count
