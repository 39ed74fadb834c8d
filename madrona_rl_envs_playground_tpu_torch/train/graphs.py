"""CUDA graphs of the port's device loops: the trainers' rollouts and PPO
epochs, and the decentralized agent's and vector env's steps.

The counterpart of JAX compiling these functions into programs (``jax.jit``
of a trainer's ``lax.scan``s: ``train/selfplay.py``'s rollout, credit scans
and epochs, ``train/mappo/runner.py``'s collect and eval,
``train/mappo/trainer.py``'s ``train``; and of ``CleanPPOAgent``'s ``_act``,
``_update_impl`` and ``_train_impl`` and ``Simulator.step`` beneath
``TpuVecEnv.n_step``).  The port's loops launch every op from Python; on
the card each owner captures each function once as a CUDA graph and replays
it on every later call, the step kernels (K1, K3, K5, K7, K9) launched
inside the captured steps.  The body is one Python function, which the CPU
runs eagerly and the capture records, so the CPU tests cover what the card
replays.  An update's graph holds forward, loss, backward, the gradient
clip and the optimizer step of every minibatch; it steps state that lives
as long as its owner (``train/optim.py``): the parameters, gradients zeroed
in place, Adam's moments, step counts and learning rate on the card
(``capturable``), MAPPO's ValueNorm statistics and the agent's rollout
buffers and step index, and a checkpoint load copies into those very
tensors.

**The rule** (``captures``): a trainer or a ``DeviceVecEnv`` on a CUDA
device whose collector steps a kernel captures its loops; a
``CleanPPOAgent`` on a CUDA device captures its act, reward credit and
train, whatever env feeds it (none of them reads the host or calls a
collective).  A kernel collector's step holds no host collective, on a
mesh too (K1's one all-reduce of the episode counter is in ``unpack``,
outside the graph).  The plain collector stays eager: on a mesh its
``batched_step`` all-gathers a scalar every step (gloo, which the card's
mesh runs use, cannot be captured), and its envs' steps read the host
(Hanabi's deal), so no graph can hold them.  On a mesh the epochs stay
eager as well: their gradient all-reduce (``all_reduce_grads``) and, for
the self-play trainer's fallback minibatches, the advantage's all-gather
are gloo calls.  The CPU is always eager.  There is no switch: a capture or
a launch that fails raises.

``LoopGraph`` holds one loop: its first call runs the loop eagerly on the
graph's side stream and returns that result (the warm-up, which fills the
kernels' per-device caches, the step kernels' scan words of that stream and
cuBLAS's workspace), then captures the loop on static copies of its
arguments; every later call copies its arguments into those static inputs
and replays.  The samplers' generators are registered with the graph, so
that a replay advances each exactly as the eager loop would and draws the
same numbers.  The wrappers' ``LAUNCHES`` counts (``ops/*.py``) count
Python calls: the capture's calls are taken back out, and every replay adds
them again.

A replay returns the graph's static outputs, which the next replay of the
same graph overwrites: a caller that keeps a result across calls clones it
(the agent and the vector env clone what they hand their callers).

Each graph has a ``name`` (``rollout``, ``scan``, ``epochs``, ``collect``,
``returns``, ``train``, ...), under which ``utils/tracing.py`` counts its
captures, replays and the bytes copied into its static inputs.  Inside a
trainer's update span a call is also timed: ``graph.capture:<name>`` (the
first call: collection, warm-up and capture, on the host's clock),
``graph.inputs:<name>`` (the copy into the static inputs) and
``graph.replay:<name>``, both on the device's clock too.  Other callers'
replays (the agent's, the vector env's, MAPPO's eval) only count.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops import acrobot, balance, cartpole, hanabi, overcooked
from ..utils import tracing

# the modules whose wrappers count their launches in LAUNCHES
LAUNCH_MODULES = (overcooked, cartpole, balance, acrobot, hanabi)

# the owners whose first capture has collected the dropped graphs
_COLLECTED = weakref.WeakSet()


def captures(device, collector=None) -> bool:
    """Whether a trainer or a ``DeviceVecEnv`` on ``device`` stepping
    through ``collector`` (``train/fused_collect.py``; on a mesh, the
    mesh's collector) captures its loops: on a CUDA device with a kernel
    collector.  Without a collector (the agent's functions, which step no
    env): on a CUDA device."""
    return torch.device(device).type == "cuda" and (collector is None or collector.kernel)


def tree_map(fn: Callable, tree):
    """``fn`` applied to every tensor of a tree of tuples, lists, dicts and
    dataclasses; other leaves (None, numbers) kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def tree_leaves(tree) -> list:
    """The tensors of a tree, in ``tree_map``'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def launch_counts() -> Dict[Tuple[str, str], int]:
    return {(m.__name__, k): n for m in LAUNCH_MODULES for k, n in m.LAUNCHES.items()}


def add_launches(delta: Dict[Tuple[str, str], int], sign: int = 1) -> None:
    by_name = {m.__name__: m for m in LAUNCH_MODULES}
    for (mod, key), n in delta.items():
        by_name[mod].LAUNCHES[key] += sign * n


class LoopGraph:
    """``fn(*args)`` on the card, replayed from a CUDA graph.

    ``args`` is a tree of CUDA tensors (``tree_map``) of the same shapes,
    dtypes and structure on every call; ``fn`` reads nothing else that
    changes between calls other than in place (the nets' parameters, the
    optimizers' and ValueNorm's state and the agent's carry, which the
    bodies write in place, and the ``generators``, each registered with the
    graph).  ``fn`` returns a tree of tensors.  ``owner`` is the object
    whose graphs these are (a trainer, an agent, an env): the dropped
    graphs are collected before the first capture of each owner's graphs
    only, and before every capture of a graph without one.  ``name``
    (default ``fn``'s) names the graph's spans and counters."""

    def __init__(self, fn: Callable, generators: Sequence[torch.Generator] = (), owner=None,
                 name: Optional[str] = None):
        self.fn = fn
        self.generators = tuple(generators)
        self.owner = owner
        self.name = name or getattr(fn, "__name__", "loop")
        self.stream = None  # the side stream of the warm-up and the capture
        self.graph = None
        self.launches: Dict[Tuple[str, str], int] = {}  # a replay's wrapper calls
        self.input_bytes = 0  # what a replay copies into the static inputs
        self._inputs = self._outputs = None
        self._device = None  # the static inputs' device, whose clock the spans read

    def __call__(self, *args):
        if self.graph is None:
            with tracing.span("graph.capture:" + self.name):
                self._collect()
                out = self._warm_up(args)
                self._capture(args)
            leaves = tree_leaves(self._inputs)
            self.input_bytes = sum(t.nbytes for t in leaves)
            self._device = leaves[0].device if leaves else None
            tracing.graph_captured(self.name)
            return out
        if tracing.in_update():
            with tracing.span("graph.inputs:" + self.name, self._device) as copied:
                self._copy_inputs(args)
            with tracing.span("graph.replay:" + self.name, self._device, after=copied):
                self.graph.replay()
        else:
            self._copy_inputs(args)
            self.graph.replay()
        add_launches(self.launches)
        tracing.graph_replayed(self.name, self.input_bytes)
        return self._outputs

    def _copy_inputs(self, args) -> None:
        for dst, src in zip(tree_leaves(self._inputs), tree_leaves(args), strict=True):
            dst.copy_(src)

    def _collect(self) -> None:
        """An owner and its graphs form a reference cycle, so a dropped
        owner's graph pools stay reserved until the cycle collector runs:
        collect them before the warm-up and capture of an owner's first
        graph (0.2-0.4 s each on the card), which would otherwise run short
        of memory after a few trainers."""
        if self.owner is None:
            gc.collect()
        elif self.owner not in _COLLECTED:
            gc.collect()
            _COLLECTED.add(self.owner)

    def _warm_up(self, args):
        """The first call, eager on the side stream that the capture will
        use, ordered after the caller's stream and before its next work."""
        caller = torch.cuda.current_stream()
        stream = torch.cuda.Stream()
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            out = self.fn(*args)
        caller.wait_stream(stream)
        self.stream = stream
        return out

    def _capture(self, args) -> None:
        self._inputs = tree_map(torch.clone, args)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        try:
            # thread_local: another thread's CUDA calls (gloo's workers,
            # a server's) do not void this thread's capture
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                self._outputs = self.fn(*self._inputs)
        finally:
            after = launch_counts()
            # the capture records launches and runs none
            self.launches = {k: after[k] - n for k, n in before.items() if after[k] != n}
            add_launches(self.launches, -1)
        self.graph = graph
