"""Segmented CUDA-graph capture of code that calls synchronising library
routines.

``torch.linalg.eigh`` and ``torch.linalg.svd`` read their error flag back
to the host on CUDA, and a stream capture cannot cross a host read.  Such a
call goes through ``sync_point``: outside a capture it is the call itself;
inside ``SegmentedGraph.capture`` it ends the graph being captured, and the
capture goes on in a new graph after it.  ``replay`` then launches the
graphs in order and, between two of them, makes the library call on the
buffers the first graph wrote, copying its result into the buffers the
second one reads: the same kernels, in the same order and on the same
values as an eager call, with one synchronisation at each cut.

The graphs share one memory pool and are replayed in the order they were
captured, as PyTorch requires of graphs that share a pool.  Random draws
inside the graphs come from the generators registered with each graph
(``CUDAGraph.register_generator_state``): a replay advances a generator's
Philox offset as the eager code would.

A kernel wrapper counts its launches with ``count_launch``.  A capture
runs nothing, so a launch recorded during one is counted at each replay,
as an eager call of the function would count it.

``GraphCall`` captures a function over static input buffers and replays
it, copying the inputs in and the outputs out: the fused SfM step
(``sfm.incremental._SteadyStep``) is one, and ``LoopCache`` keeps one for
each input layout of a fixed-count device loop (an LM solve).
"""
from __future__ import annotations

import contextlib
import functools
from collections import OrderedDict

import torch

from photogrammetry_tpu_torch.utils import profiling

# The SegmentedGraph capturing in this process, or None.  Module state
# because the library calls that cut a capture sit deep inside the code
# being captured; one capture at a time is a CUDA-graph rule anyway.
_ACTIVE: SegmentedGraph | None = None


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a nest of tuples, NamedTuples,
    lists and None."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    if isinstance(tree, tuple):
        vals = [tree_map(fn, x) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    raise TypeError(f"tree_map: unsupported leaf {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


@contextlib.contextmanager
def allow_sync():
    """Lower ``torch.cuda.set_sync_debug_mode("error")`` to "warn" around a
    declared synchronisation (a cut, a timing), so that code run in the
    error mode raises on every other one."""
    mode = torch.cuda.get_sync_debug_mode()
    if mode > 1:
        torch.cuda.set_sync_debug_mode(1)
    try:
        yield
    finally:
        if mode > 1:
            torch.cuda.set_sync_debug_mode(mode)


def sync_point(fn, *args):
    """``fn(*args)`` for a library call that synchronises (tensors in, a
    tensor or a tuple of tensors out): the call itself, or a cut of the
    active capture."""
    if _ACTIVE is not None:
        return _ACTIVE._cut(fn, args)
    if not args[0].is_cuda:
        return fn(*args)
    with allow_sync():
        return fn(*args)


def count_launch(fn) -> None:
    """Count one launch of the kernel wrapper ``fn`` in ``fn.launches``: at
    once, or, inside a capture, at each replay of the graph."""
    if _ACTIVE is not None:
        _ACTIVE.launches.append(fn)
    else:
        fn.launches += 1


class SegmentedGraph:
    """A function captured as a chain of CUDA graphs cut at its
    ``sync_point`` calls.  ``segments`` graphs, ``len(cuts)`` library calls
    (one synchronisation each) between them.  ``launches``: the kernel
    wrappers launched during the capture, one entry a launch, each counted
    in its ``.launches`` at every replay."""

    def __init__(self, device: torch.device, generators=(),
                 stream: torch.cuda.Stream | None = None):
        self.device = device
        self.generators = tuple(generators)
        self.stream = stream or torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list[torch.cuda.CUDAGraph] = []
        self.cuts: list = []        # (fn, input buffers, output buffers)
        self.launches: list = []    # the wrapper of each captured launch

    @property
    def segments(self) -> int:
        return len(self.graphs)

    def _begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            g.register_generator_state(gen)
        # "thread_local": a CUDA call of another thread of this process
        # (the profiler's) may not invalidate the capture
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graphs.append(g)

    def _cut(self, fn, args):
        self.graphs[-1].capture_end()
        # the graph before the cut has only been recorded, not run: the
        # call here gives the output buffers their shapes, on zeros
        with allow_sync():
            outs = fn(*(torch.zeros_like(a) for a in args))
        self.cuts.append((fn, args, outs))
        self._begin()
        return outs

    def capture(self, fn, *args):
        """Capture ``fn(*args)`` (run nothing) and return its outputs: the
        buffers each replay writes.  A capture that fails raises, and this
        object is then unusable."""
        global _ACTIVE
        if _ACTIVE is not None or self.graphs:
            raise RuntimeError("SegmentedGraph: a capture is under way or "
                               "done")
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self._begin()
            _ACTIVE = self
            try:
                out = fn(*args)
            except BaseException:
                _ACTIVE = None
                try:
                    self.graphs[-1].capture_end()
                except RuntimeError:
                    pass    # the capture was invalidated: the first error
                self.graphs.clear()
                self.cuts.clear()
                self.launches.clear()
                raise
            _ACTIVE = None
            self.graphs[-1].capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        return out

    def replay(self) -> None:
        """Every graph in order on the current stream, each cut's library
        call between two."""
        for i, g in enumerate(self.graphs):
            g.replay()
            if i < len(self.cuts):
                fn, args, outs = self.cuts[i]
                with allow_sync():
                    new = fn(*args)
                for o, n in zip(tree_leaves(outs), tree_leaves(new)):
                    o.copy_(n)
        for fn in self.launches:
            fn.launches += 1


# -- captured calls and fixed-count loops as cached CUDA graphs ---------------

# device -> the one capture stream: a library workspace allocated for a
# stream is kept for the process, so every capture shares one
_STREAMS: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The capture stream of the CUDA ``device`` (without an index, the
    current device), made at its first use."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


class GraphCall:
    """``fn(*args)`` captured once, on the device's capture stream, over
    static input buffers (clones of the first call's tensors; ``args`` a
    tuple of nests of tuples, NamedTuples and None) and replayed.

    A call copies its arguments into the buffers, replays the capture and
    returns clones of the outputs.  The first ``reuse`` arguments are
    copied only when they are other objects than at the last call (the
    first call's are in the buffers); the rest at every call.  A call
    from another stream than the last waits for the last.  ``generators``:
    those the capture draws from, each replay advancing them; ``graph``:
    the ``SegmentedGraph``."""

    def __init__(self, fn, args: tuple, generators=(), reuse: int = 0):
        self.device = tree_leaves(args)[0].device
        self.inputs = tree_map(torch.clone, args)
        self.reuse = reuse
        self._held = args[:reuse]
        self.graph = SegmentedGraph(self.device, generators,
                                    capture_stream(self.device))
        self.outputs = self.graph.capture(fn, *self.inputs)
        self._last_stream = torch.cuda.current_stream(self.device)

    def replay(self, args: tuple):
        """Copy ``args`` in and replay; returns the output buffers, which
        the next replay overwrites."""
        cur = torch.cuda.current_stream(self.device)
        if cur != self._last_stream:
            cur.wait_stream(self._last_stream)
            self._last_stream = cur
        n = self.reuse
        if any(a is not b for a, b in zip(args[:n], self._held)):
            self._load(self.inputs[:n], args[:n])
            self._held = args[:n]
        self._load(self.inputs[n:], args[n:])
        self.graph.replay()
        return self.outputs

    @staticmethod
    def _load(dst, src) -> None:
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s)

    def __call__(self, args: tuple):
        return tree_map(torch.clone, self.replay(args))


# A CUDA solve whose key was seen before replays a capture of its loop:
# the same kernels on the same values, launched as one graph.  The key
# holds all that the capture bakes in: each input tensor's shape, strides
# and dtype (None where not given), the device and the Python arguments.
# A key is captured on its second call, so one-off shapes pay no capture.


def _layouts(tree) -> list:
    """(shape, strides, dtype) of each tensor of ``tree`` in ``tree_map``'s
    order, None for each None."""
    if tree is None:
        return [None]
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), tree.stride(), tree.dtype)]
    return [layout for x in tree for layout in _layouts(x)]


def loop_key(args, opts) -> tuple:
    """The cache key of ``loop(*args, **opts)``."""
    return (tree_leaves(args)[0].device, tuple(_layouts(args)),
            tuple(sorted(opts.items())))


class LoopCache:
    """The captures of one fixed-count loop, by key, each a ``GraphCall``.

    ``loop(*args, tally=False, **opts)`` takes tensors (a nest of tuples,
    NamedTuples and None) and Python options, reads nothing back to the
    host, and returns its outputs followed by the number of accepted
    steps, a 0-dim tensor where ``tally`` is true, else None; it counts
    each step's accept flag in ``<prefix>.lm_accepted``.  Recording
    (``utils.profiling``), a CUDA solve counts ``<prefix>.graph_replays``
    (a capture's own replay included), ``<prefix>.graph_captures`` and
    ``<prefix>.eager_solves`` (CUDA solves run eagerly).

    At most ``MAX_GRAPHS`` captures are kept: a key that finds the cache
    full runs eagerly and evicts the least recently replayed capture, so
    that its next call captures.  The keys seen once are remembered up to
    ``MAX_SEEN``."""

    MAX_GRAPHS = 8
    MAX_SEEN = 64

    def __init__(self, loop, prefix: str):
        self.loop = loop
        self.graphs: OrderedDict = OrderedDict()    # key -> GraphCall
        self.seen: OrderedDict = OrderedDict()      # key -> None
        self.replays = f"{prefix}.graph_replays"
        self.captures = f"{prefix}.graph_captures"
        self.eager = f"{prefix}.eager_solves"
        self.accepted = f"{prefix}.lm_accepted"

    def _replay(self, call: GraphCall, args):
        """The replay's outputs but its tally, as copies; recording, the
        tally goes to the accept counter as a copy too."""
        *outputs, accepted = call.replay(args)
        if profiling.is_recording():
            profiling.count(self.accepted, accepted.clone())
        return tree_map(torch.clone, tuple(outputs))

    def solve(self, args, opts):
        """The loop's outputs but its tally: eager, captured or replayed, as
        the device, the capture state and the cache decide."""
        first = tree_leaves(args)[0]
        if not first.is_cuda:
            return self.loop(*args, **opts)[:-1]
        if _ACTIVE is not None or torch.cuda.is_current_stream_capturing():
            # recorded into the enclosing capture
            profiling.count(self.eager, 1)
            return self.loop(*args, **opts)[:-1]
        key = loop_key(args, opts)
        call = self.graphs.get(key)
        if call is not None:
            self.graphs.move_to_end(key)
            profiling.count(self.replays, 1)
            return self._replay(call, args)
        if key in self.seen and len(self.graphs) < self.MAX_GRAPHS:
            # the key's first call ran eagerly: the library handles the
            # capture needs exist
            profiling.count(self.captures, 1)
            profiling.count(self.replays, 1)
            call = self.graphs[key] = GraphCall(
                functools.partial(self.loop, tally=True, **opts), args)
            return self._replay(call, args)
        profiling.count(self.eager, 1)
        if key not in self.seen:
            self.seen[key] = None
            if len(self.seen) > self.MAX_SEEN:
                self.seen.popitem(last=False)
        elif self.graphs:
            # the cache is full: the evicted capture's last replay may still
            # be queued
            with allow_sync():
                torch.cuda.current_stream(first.device).synchronize()
            self.graphs.popitem(last=False)
        return self.loop(*args, **opts)[:-1]
