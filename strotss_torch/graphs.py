"""The step as a replayed CUDA graph: one captured step a key, replayed
in every later call with that key.

PyTorch issues a step op by op from the host: about 550 launches for one
pair, 2900 for a batch of 8 (``PERF.md`` §5), which take the host several
times longer than the card takes to run them. A CUDA graph issues the
whole step in one launch. The JAX package has the same role filled by its
one compiled program a scale (``strotss_tpu/programs.py:507-539``,
``strotss_tpu/aot.py``).

A key is everything the captured step bakes in: the step's spec and
alpha (or each pair's), the shapes, dtypes and strides of every tensor it
reads and of the pyramid, RMSprop's hyperparameters, the number of
generators, VGG's configuration and its parameters' shapes, and whether
PyTorch's deterministic algorithms are on. Its entry owns:

- a copy of each tensor the step reads or writes (the pyramid leaves,
  the RMSprop slots, the content features, the style targets and their
  moments) and VGG's parameters (one copy a parameter set, shared by
  every entry); a call copies into them only what is not already there,
  judged by tensor identity and version, so a scale's later calls copy
  nothing but the state they wrote back;
- one generator a pair, registered with the graph, whose state a call
  sets from its own step generators before the replays and hands back
  after them, so the coordinates are the eager draws bit for bit;
- the graph, its loss row and the kernels' scratch
  (:func:`strotss_torch.ops.kernels.common.capturing_into`).

A key's first step runs eagerly: it is a real step, and it makes cuDNN's
plans and each kernel's one-time set-up before anything is captured. Its
second step is captured and replayed; every later one replays. A call
hands back the pyramid, the RMSprop slots and the generators' states as
the eager steps would have left them, and each step's loss row as a copy.

Every graph of a device allocates from one memory pool, so a later
capture may place its tensors where an earlier graph keeps its
temporaries. That is safe here: the graphs replay one at a time on one
stream, each replay writes every tensor of its graph (temporaries,
scratch, the loss row) before it reads it, and the loss row is copied
out before another graph replays. The state that lasts from one replay
to the next (the copies, the generators) lies outside the pool.

The cache keeps the graphs of the last stylization (:func:`end_call`):
its gain needs calls of one shape in a row, as a service's stream of jobs
of one size or a benchmark's loop gives; a call of another shape
captures its own and drops them. :func:`clear` empties it.
"""

from __future__ import annotations

import copy
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch

from strotss_torch.models.vgg import VGG
from strotss_torch.ops.kernels.common import capturing_into
from strotss_torch.utils.timing import count, span


def _flatten(x, out: List[torch.Tensor]):
    """The structure of nested lists and tuples (NamedTuples too) of
    tensors and other values, its tensors appended to ``out``: a hashable
    token, in which the other values stand as themselves."""
    if isinstance(x, torch.Tensor):
        out.append(x)
        return None
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(v, out) for v in x))
    return ("value", x)


def _build(token, tensors):
    """The structure of ``token`` with the tensors of the iterator
    ``tensors`` in its tensors' places."""
    if token is None:
        return next(tensors)
    kind, kids = token
    if kind == "value":
        return kids
    vals = [_build(k, tensors) for k in kids]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def _sig(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.stride(), str(t.device))
                 for t in tensors)


def _params(vgg: VGG) -> List[torch.Tensor]:
    return [t for name in vgg.names for t in (
        getattr(vgg, f"{name}_kernel"), getattr(vgg, f"{name}_bias"))]


def graph_key(tag, vgg: VGG, inputs, pyramid, opt, n_gens: int) -> tuple:
    """The key of a step: ``tag`` (the step's kind, its spec and what else
    it bakes in as values), the structure and non-tensor values of
    ``inputs`` and the signatures of its tensors, the pyramid's, RMSprop's
    hyperparameters, the number of generators, VGG's configuration and
    its parameters' signatures, and PyTorch's deterministic switch (which
    picks other kernels)."""
    flat: List[torch.Tensor] = []
    token = _flatten(inputs, flat)
    return (tag, token, _sig(flat), _sig(pyramid),
            (opt.lr, opt.rho, opt.eps), n_gens,
            (vgg.taps, vgg.vgg_type, vgg.preprocess_mode, vgg.compute_dtype,
             vgg.block1_impl), _sig(_params(vgg)),
            torch.are_deterministic_algorithms_enabled())


class _Copies:
    """Copies of some tensors, refilled from their sources only where a
    source is another tensor, or the same one written since."""

    def __init__(self, like: Sequence[torch.Tensor]):
        self.copies = [torch.empty_like(t) for t in like]
        self.seen: List[Optional[tuple]] = [None] * len(self.copies)

    @staticmethod
    def _same(seen, src: torch.Tensor) -> bool:
        return (seen is not None and seen[0]() is src
                and seen[1] == src._version)

    def fill(self, sources: Sequence[torch.Tensor]) -> None:
        stale = [i for i, s in enumerate(sources)
                 if not self._same(self.seen[i], s)]
        if stale:
            with torch.no_grad():
                torch._foreach_copy_([self.copies[i] for i in stale],
                                     [sources[i] for i in stale])
            for i in stale:
                self.seen[i] = (weakref.ref(sources[i]), sources[i]._version)

    def hand_back(self, sources: Sequence[torch.Tensor]) -> None:
        """Write the copies into ``sources``, which then hold the same
        values."""
        with torch.no_grad():
            torch._foreach_copy_(list(sources), self.copies)
        self.seen = [(weakref.ref(s), s._version) for s in sources]


class _Entry:
    """One key's graph and what it reads and writes."""

    def __init__(self):
        self.warm = False  # its first step has run eagerly
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def make(self, params: _Copies, vgg: VGG, inputs, pyramid, opt,
             n_gens: int) -> None:
        """The copies the graph will read and write, before its capture."""
        flat: List[torch.Tensor] = []
        self.token = _flatten(inputs, flat)
        self.inputs = _Copies(flat)
        self.state = _Copies(list(pyramid) + list(opt.nu))
        n = len(pyramid)
        self.pyramid = self.state.copies[:n]
        self.opt = copy.copy(opt)
        self.opt.params, self.opt.nu = self.pyramid, self.state.copies[n:]
        self.params = params
        it = iter(params.copies)
        self.vgg = VGG({name: {"kernel": next(it), "bias": next(it)}
                        for name in vgg.names}, taps=vgg.taps,
                       vgg_type=vgg.vgg_type,
                       preprocess_mode=vgg.preprocess_mode,
                       compute_dtype=vgg.compute_dtype,
                       block1_impl=vgg.block1_impl)
        self.device = pyramid[0].device
        self.gens = [torch.Generator(device=self.device)
                     for _ in range(n_gens)]
        self.store: Dict = {}

    def fill(self, inputs, pyramid, opt) -> None:
        flat: List[torch.Tensor] = []
        _flatten(inputs, flat)
        self.inputs.fill(flat)
        self.state.fill(list(pyramid) + list(opt.nu))

    def capture(self, step: Callable, t: int, step_gens, pool,
                side: torch.cuda.Stream) -> None:
        """Capture one step on the copies, on the stream ``side`` (CUDA
        captures on a stream other than the default one) with its
        tensors from the memory pool ``pool``, the coordinates drawn
        through the graph's generators: ``step_gens`` share their states
        while the step is captured, and get their own back after. The
        allocator's cache is left as it is."""
        graph = torch.cuda.CUDAGraph()
        for g in self.gens:
            graph.register_generator_state(g)
        own = [g.graphsafe_get_state() for g in step_gens]
        for g, mine in zip(step_gens, self.gens):
            g.graphsafe_set_state(mine)
        side.wait_stream(torch.cuda.current_stream())
        try:
            with capturing_into(self.store), torch.cuda.stream(side):
                graph.capture_begin(pool=pool)
                try:
                    self.row = step(
                        t, self.vgg,
                        _build(self.token, iter(self.inputs.copies)),
                        self.pyramid, self.opt)
                finally:
                    graph.capture_end()
        finally:
            for g, state in zip(step_gens, own):
                g.graphsafe_set_state(state)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = graph


class StepGraphs:
    """The entries of the last stylization's keys, one copy of VGG's
    parameters a parameter set, a device's memory pool while a graph holds
    it, and a device's capture stream for the process: the allocator hands
    a block freed on one stream only to allocations on that stream, and
    cuBLAS keeps a workspace for each stream it runs on, so every capture
    of a device is made on one stream."""

    def __init__(self):
        self.entries: Dict[tuple, _Entry] = {}
        self.used: set = set()
        self.params: Dict[tuple, _Copies] = {}
        self.pools: Dict[torch.device, tuple] = {}
        self.streams: Dict[torch.device, torch.cuda.Stream] = {}

    def clear(self) -> None:
        self.entries.clear()
        self.used.clear()
        self.params.clear()
        self.pools.clear()

    def end_call(self) -> None:
        """Drop the entries that no call used since the last
        ``end_call``, and the parameter copies and pools that no graph
        left holds: the allocator refuses a pool to a capture once every
        graph of it is gone."""
        self.entries = {k: e for k, e in self.entries.items()
                        if k in self.used}
        self.used.clear()
        held = [e for e in self.entries.values() if e.graph is not None]
        self.params = {k: c for k, c in self.params.items()
                       if any(e.params is c for e in held)}
        self.pools = {d: h for d, h in self.pools.items()
                      if any(e.device == d for e in held)}

    def run(self, tag, n_steps: int, step: Callable, vgg: VGG, inputs,
            pyramid, opt, step_gens) -> torch.Tensor:
        """``n_steps`` steps of ``step(t, vgg, inputs, pyramid, opt)``
        (one step on those objects, its loss row back), the first of a
        key's eagerly, its second captured, every later one replayed."""
        key = graph_key(tag, vgg, inputs, pyramid, opt, len(step_gens))
        e = self.entries.setdefault(key, _Entry())
        self.used.add(key)
        count("graph.hit" if e.graph is not None else "graph.miss")
        # a graph is captured on, and replayed into, the current device's
        # streams: the run's device
        with torch.cuda.device(pyramid[0].device):
            rows = self._steps(e, n_steps, step, vgg, inputs, pyramid, opt,
                               step_gens)
        return torch.stack(rows)

    def _steps(self, e: _Entry, n_steps: int, step, vgg, inputs, pyramid,
               opt, step_gens) -> List[torch.Tensor]:
        rows, live = [], False
        for t in range(n_steps):
            with span("step"):
                if not e.warm:
                    e.warm = True
                    rows.append(step(t, vgg, inputs, pyramid, opt))
                    continue
                if not live:
                    params = self._params(vgg)
                    if e.graph is None:
                        e.make(params, vgg, inputs, pyramid, opt,
                               len(step_gens))
                    e.fill(inputs, pyramid, opt)
                    for mine, g in zip(e.gens, step_gens):
                        mine.set_state(g.get_state())
                    live = True
                if e.graph is None:
                    with span("step.capture"):
                        e.capture(step, t, step_gens,
                                  *self._pool(pyramid[0].device))
                    count("graph.capture")
                with span("step.replay"):
                    e.graph.replay()
                count("graph.replay")
                rows.append(e.row.clone())
        if live:
            e.state.hand_back(list(pyramid) + list(opt.nu))
            for mine, g in zip(e.gens, step_gens):
                g.set_state(mine.get_state())
        return rows

    def _params(self, vgg: VGG) -> _Copies:
        """The copy of ``vgg``'s parameters, filled from them."""
        src = _params(vgg)
        key = _sig(src)
        copies = self.params.get(key)
        if copies is None:
            copies = self.params[key] = _Copies(src)
        copies.fill(src)
        return copies

    def _pool(self, device: torch.device) -> tuple:
        """The device's memory pool and capture stream."""
        if device not in self.pools:
            self.pools[device] = torch.cuda.graph_pool_handle()
        if device not in self.streams:
            self.streams[device] = torch.cuda.Stream(device)
        return self.pools[device], self.streams[device]


_graphs = StepGraphs()


def replayed(tag, n_steps: int, step: Callable, vgg: VGG, inputs, pyramid,
             opt, step_gens) -> torch.Tensor:
    """:meth:`StepGraphs.run` on the process's cache: the steps of a call
    that :func:`strotss_torch.programs.step_route` sends to a graph."""
    return _graphs.run(tag, n_steps, step, vgg, inputs, pyramid, opt,
                       step_gens)


def end_call() -> None:
    """A stylization has finished: keep the graphs it used, drop the
    rest."""
    _graphs.end_call()


def clear() -> None:
    """Drop every captured graph and every copy."""
    _graphs.clear()
