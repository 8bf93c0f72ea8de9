"""The render layer's error-bound sampler, replayed as CUDA graphs.

`MultiplyRenderer._sampler_chain` (`ray_sampler.error_bound_sample` over every
person's SDF: the deformer's inverse, the implicit net, 5 rounds of sort,
bisection and inverse-CDF draws, the final draw) has fixed shapes, runs
without autograd and never waits on the host, yet enqueues ~2.8k small kernels
a call: the host spends ~100 ms enqueueing ~47 ms of the card's work.
`SamplerGraphs` records the chain once per signature and replays it.

* What engages is decided from the inputs. CUDA inputs are keyed by their
  shapes, strides and types and the call's flags (`GraphPolicy`): the first
  call of a signature runs eagerly, the second captures, later ones replay. At
  most `CAPACITY` graphs are kept, the least recently used dropped first, and
  a signature seen once (the ragged last chunk of a full-frame render) never
  takes one. CPU inputs always run the eager chain.
* Inputs are copied into static buffers laid out as they are (a broadcast
  dimension stays broadcast); parameters are read in place, as the optimizer
  updates them in place. The data pointers of the leaves the chain reads are
  recorded at capture; where one differs at a call (a loaded checkpoint, a
  replaced parameter), the chain is captured anew: a replay never reads
  stale weights.
* Each `nn1` launch is a hole in the graph: `knn_cuda.nn1_holes` hands the
  capturing thread's launches to `_capture`, which ends a segment there and
  begins the next, so the chain is captured as segments around the launches.
  A replay launches `nn1` between its segments through `knn_cuda.nn1_kernel`
  and copies the result into the static outputs that the next segment reads.
  So every launch is made, counted (`nn1.launches`) and seen by whoever wraps
  `nn1_kernel`, as it is eagerly.
* A capturing call records the chain on a side stream with a thread-local
  capture, so that the data layer's producer thread goes on using the card
  meanwhile, and then replays it for its result. Nothing runs eagerly on the
  side stream: the signature's eager first call has made the chain's lazy
  state (the kernels' modules, cuBLAS's handle).
* All graphs of one renderer record into one memory pool. They replay one
  after another on one stream, and each call clones its outputs before the
  next replay, so a graph may reuse what another freed at its capture.

Counters (`utils/profiling.py`), one a call: `sampler.eager`,
`sampler.graph_captures`, `sampler.graph_replays`. A capture or a replay
counts the `sampler.points` that the chain counted when it was recorded.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Callable

import torch

from ..ops import knn_cuda
from ..utils.profiling import count

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"
CAPACITY = 4  # graphs kept: the training step's, a full-frame render's chunk, and room for a change of R
MEMORY = 64  # signatures remembered as seen once


class GraphPolicy:
    """Which call of a signature runs eagerly, captures or replays: the first
    sighting runs eagerly, the second captures, later ones replay. Keeps at
    most `CAPACITY` graphs (least recently used out first) and remembers at
    most `MEMORY` signatures seen once."""

    def __init__(self):
        self.graphs: OrderedDict = OrderedDict()  # signature -> graph
        self.seen: OrderedDict = OrderedDict()  # signatures seen once

    def plan(self, key) -> str:
        if key in self.graphs:
            self.graphs.move_to_end(key)
            return REPLAY
        if key in self.seen:
            return CAPTURE
        self.seen[key] = None
        if len(self.seen) > MEMORY:
            self.seen.popitem(last=False)
        return EAGER

    def keep(self, key, graph) -> None:
        self.seen.pop(key, None)
        self.graphs[key] = graph
        self.graphs.move_to_end(key)
        while len(self.graphs) > CAPACITY:
            self.graphs.popitem(last=False)


def _compact(t: torch.Tensor) -> torch.Tensor:
    """`t` without its broadcast copies: size 1 where its stride is 0."""
    for d, (n, st) in enumerate(zip(t.shape, t.stride())):
        if st == 0 and n > 1:
            t = t.narrow(d, 0, 1)
    return t


class _Recorded:
    """A chain recorded as graph segments with an `nn1` launch after each but
    the last: its static inputs (buffer, view as the chain saw it), outputs,
    leaf pointers and the points it counted."""

    def __init__(self, inputs: dict, leaves: tuple):
        self.buffers = {k: torch.empty_strided(c.shape, c.stride(), dtype=c.dtype, device=c.device)
                        for k, c in ((k, _compact(v)) for k, v in inputs.items() if v is not None)}
        self.views = {k: None if v is None else self.buffers[k].expand(v.shape) for k, v in inputs.items()}
        self.leaves = leaves
        self.segments: list[torch.cuda.CUDAGraph] = []
        self.holes: list[tuple] = []  # (query, refs, d2, idx)
        self.outputs: dict = {}
        self.points = 0

    def load(self, inputs: dict) -> None:
        for k, buf in self.buffers.items():
            buf.copy_(_compact(inputs[k]))

    def replay(self) -> None:
        for segment, hole in itertools.zip_longest(self.segments, self.holes):
            segment.replay()
            if hole is not None:
                query, refs, d2, idx = hole
                got_d2, got_idx = knn_cuda.nn1_kernel(query, refs)
                d2.copy_(got_d2)
                idx.copy_(got_idx)


def _count_points(n: int) -> None:
    count("sampler.points", n)


class SamplerGraphs:
    """The sampler chain's graphs of one renderer (see the module's notes).
    A copy or a pickle starts empty: graphs belong to one process and model."""

    def __init__(self):
        self.policy = GraphPolicy()
        self._stream: torch.cuda.Stream | None = None
        self._pool = None  # the graphs' memory pool

    def __reduce__(self):
        return type(self), ()

    def __call__(self, chain: Callable, inputs: dict, flags: tuple, leaves: Callable) -> dict:
        """`chain(inputs, on_points)` -> {name: tensor}, computed from `inputs`
        ({name: tensor or None}) and the tensors `leaves()` gives, read in
        place; `on_points(n)` is called with each evaluation's point count.
        `flags` (hashable) are what else the chain depends on."""
        given = [v for v in inputs.values() if v is not None]
        if not all(v.is_cuda for v in given):
            count("sampler.eager")
            return chain(inputs, _count_points)
        key = (flags,) + tuple(
            (k, None) if v is None else (k, tuple(v.shape), v.stride(), v.dtype, v.device) for k, v in inputs.items()
        )
        plan = self.policy.plan(key)
        if plan == EAGER:
            count("sampler.eager")
            return chain(inputs, _count_points)
        ptrs = tuple(t.data_ptr() for t in leaves())
        rec = self.policy.graphs.get(key)
        if plan == REPLAY and rec.leaves == ptrs:
            count("sampler.graph_replays")
        else:
            count("sampler.graph_captures")
            rec = self._capture(chain, inputs, ptrs)
            self.policy.keep(key, rec)
        rec.load(inputs)
        rec.replay()
        count("sampler.points", rec.points)
        return {k: v.clone() for k, v in rec.outputs.items()}

    def _capture(self, chain: Callable, inputs: dict, ptrs: tuple) -> _Recorded:
        device = next(v for v in inputs.values() if v is not None).device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        main, side, pool = torch.cuda.current_stream(device), self._stream, self._pool
        rec = _Recorded(inputs, ptrs)
        tally: list[int] = []
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.no_grad():
            segment = torch.cuda.CUDAGraph()

            def hole(query, refs):
                nonlocal segment
                segment.capture_end()
                rec.segments.append(segment)
                with torch.cuda.stream(main):  # the replays' stream writes them
                    d2 = query.new_empty(query.shape[:-1] + (1,))
                    idx = torch.empty(d2.shape, dtype=torch.int64, device=query.device)
                rec.holes.append((query, refs, d2, idx))
                segment = torch.cuda.CUDAGraph()
                segment.capture_begin(pool=pool, capture_error_mode="thread_local")
                return d2, idx

            segment.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                with knn_cuda.nn1_holes(hole):
                    rec.outputs = chain(rec.views, tally.append)
            finally:
                segment.capture_end()
            rec.segments.append(segment)
        main.wait_stream(side)
        rec.points = sum(tally)
        return rec
