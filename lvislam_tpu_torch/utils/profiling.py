"""Tracing and timing helpers — port of ``lvislam_tpu.utils.profiling``
(SURVEY.md §5: the reference has only TicToc wall timers with their prints
disabled).

- `trace(logdir)`: a context manager around ``torch.profiler`` (CPU and, on
  the card, CUDA activity) that writes a Chrome trace
  (``logdir/trace.json``) when it closes; where the profiler cannot start it
  degrades to a no-op, as the JAX one does.
- `hard_sync(tree)`: wait for the work feeding the tensors of `tree`:
  ``torch.cuda.synchronize`` on each CUDA device they lie on (a CPU tensor
  is ready when it exists). The JAX package reads a value back because
  ``block_until_ready`` was unreliable over its TPU transport; a CUDA
  synchronize is exact here.
- `device_timer(label, result_box, device)`: seconds of the block. Given a
  CUDA `device`, the time is taken by CUDA events recorded around the block
  on that device's stream. Otherwise it is ``time.perf_counter``; as in the
  JAX helper, the caller may then put the block's output into the yielded
  dict's ``"out"``, whose devices are drained before the clock is read.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    prof = None
    try:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except Exception:
                pass


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def _cuda_devices(tree) -> set:
    return {t.device for t in _tensors(tree) if t.device.type == "cuda"}


def hard_sync(tree) -> None:
    """Wait for all pending work on the CUDA devices of `tree`'s tensors."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_timer(label: str, result_box: dict | None = None, device=None):
    """Seconds of the block into ``result_box[label]``: CUDA events when
    `device` is a card; otherwise ``perf_counter``, read after `hard_sync`
    of the block's ``"out"`` (event timing needs `device`)."""
    holder: dict = {}
    dev = torch.device(device) if device is not None else None
    cuda = dev is not None and dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
    t0 = time.perf_counter()
    try:
        yield holder
    finally:
        if cuda:
            end.record(torch.cuda.current_stream(dev))
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            if "out" in holder:
                hard_sync(holder["out"])
            dt = time.perf_counter() - t0
        if result_box is not None:
            result_box[label] = dt
