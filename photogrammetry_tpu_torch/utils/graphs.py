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
"""
from __future__ import annotations

import contextlib

import torch

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
