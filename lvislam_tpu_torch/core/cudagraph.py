"""CUDA graphs of the port's fixed-shape device programs: a function
captured once per signature of its inputs and replayed, so that thousands of
small launches from Python become one.

The owner of a captured function (``ops/ba.py``, ``models/lio/imu_fusion.py``)
keeps its own cache of graphs, its own count of captures and its own span
names; this module holds what they share:

- ``graphable``: graphs replay where the inputs are on a card and no
  ``torch.func`` transform, autograd or other capture is active; everywhere
  else the owner runs the same function eagerly;
- ``capture``: one warm-up on a side stream (lazy handles and workspaces),
  then the capture;
- ``Graphed``: static, contiguous copies of a call's tensor arguments, which
  each call copies its own values into before the replay;
- ``cached``: the graphs of one signature (every tensor's shape, dtype and
  device, which are None, and the owner's key), captured at its first call.

A graph replays the kernels the eager function launches, in their order, on
the same data, so its results are the eager ones bit for bit.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function


def tmap(fn, x):
    """`fn` over the tensors of a (nested) tuple or NamedTuple; None stays."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(x)
    items = [tmap(fn, y) for y in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def leaves(x) -> list:
    """The tensors of a (nested) tuple or NamedTuple in order, with None
    where an optional one is left out."""
    if x is None or isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in leaves(y)]


def graphable(args) -> bool:
    """Replay graphs where the inputs are on a card and no `torch.func`
    transform, autograd or other capture is active; run eagerly otherwise."""
    ts = [t for t in leaves(args) if t is not None]
    return (ts[0].is_cuda
            and not torch._C._are_functorch_transforms_active()
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in ts))
            and not torch.cuda.is_current_stream_capturing())


def capture(fn, span: str):
    """`fn` run once on a side stream (lazy handles and workspaces), then
    captured, inside the span `span`: (the graph, what the captured call
    returned)."""
    with record_function(span):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
    return graph, out


def replay(graph, span: str) -> None:
    with record_function(span):
        graph.replay()


class Graphed:
    """Static, contiguous copies of a call's tensor arguments; a call copies
    its arguments in (`load`) before replaying."""

    def __init__(self, args):
        self.args = tmap(lambda t: t.clone(memory_format=torch.contiguous_format), args)

    def load(self, args) -> None:
        for dst, src in zip(leaves(self.args), leaves(args)):
            if dst is not None:
                dst.copy_(src)


def cached(graphs: dict, kind, args, key) -> Graphed:
    """The graphs ``kind(args, key)`` for this signature of `args` (every
    tensor's shape, dtype and device; which are None) and `key`, kept in
    `graphs` and captured at the first call that has it, with this call's
    values loaded. Strides are left out: a view (a stride-0 bias, a column
    slice of an IMU buffer) and the same values stored whole share the
    graphs."""
    sig = tuple(None if t is None else (t.shape, t.dtype, t.device) for t in leaves(args))
    k = (kind, key, sig)
    g = graphs.get(k)
    if g is None:
        g = graphs[k] = kind(args, key)
    g.load(args)
    return g
