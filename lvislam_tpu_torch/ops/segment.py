"""Deterministic scatter helpers.

XLA's scatters run in update order on the CPU; a CUDA ``index_add_`` on
floats uses atomics whose order changes from run to run, and an
``index_put_`` with repeated indices leaves the winner unspecified. The port
replaces every such scatter on the LIO path with one of these, which give the
same bits on every run and device:

- ``segment_sum``: sum of consecutive rows sharing a (sorted) segment id, each
  segment accumulated in row order (``torch.segment_reduce``, one sequential
  loop per segment — the order XLA's CPU scatter-add uses);
- ``scatter_add``: ``x.at[idx].add(v, mode="drop")`` built on a stable sort
  and ``segment_sum``;
- ``scatter_set``: ``x.at[idx].set(v, mode="drop")`` where the LAST update
  of a repeated index wins, as in XLA's in-order scatter.
"""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n_seg: int):
    """Per-segment sums of `values` rows; `seg` (N,) int must be
    non-decreasing with entries in [0, n_seg). Returns (n_seg, ...)."""
    lengths = torch.bincount(seg, minlength=n_seg)
    return torch.segment_reduce(values, "sum", lengths=lengths, unsafe=True)


def _in_range(idx: torch.Tensor, size: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < size), idx,
                       torch.full_like(idx, size))


def scatter_add(target: torch.Tensor, idx: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``target.at[idx].add(values, mode="drop")`` along dim 0,
    with each destination's updates summed in update order."""
    T = target.shape[0]
    i = _in_range(idx, T)
    order = torch.sort(i, stable=True).indices
    sums = segment_sum(values[order].to(target.dtype), i[order], T + 1)
    return target + sums[:T]


def scatter_set(target: torch.Tensor, idx: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``target.at[idx].set(values, mode="drop")`` along dim 0;
    of repeated indices the last update wins."""
    T = target.shape[0]
    i = _in_range(idx, T)
    srt = torch.sort(i, stable=True)
    s = srt.values
    last_sorted = torch.ones_like(s, dtype=torch.bool)
    last_sorted[:-1] = s[1:] != s[:-1]
    last = torch.zeros_like(last_sorted)
    last[srt.indices] = last_sorted
    i = torch.where(last, i, torch.full_like(i, T))
    return set_rows(target, i, values)


def set_rows(target: torch.Tensor, idx: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``target.at[idx].set(values, mode="drop")`` for indices
    that are unique wherever they are in range. Each out-of-range update
    gets a trash row of its own, so the scatter never sees a repeated index
    (a deterministic CUDA ``index_put_`` walks a repeated index's updates
    one by one)."""
    T, N = target.shape[0], idx.shape[0]
    i = idx.long()
    i = torch.where((i >= 0) & (i < T), i,
                    T + torch.arange(N, device=i.device))
    ext = torch.cat([target, target.new_zeros((N,) + target.shape[1:])], dim=0)
    values = torch.as_tensor(values, dtype=target.dtype, device=target.device)
    ext[i] = values.expand((N,) + target.shape[1:])
    return ext[:T]
