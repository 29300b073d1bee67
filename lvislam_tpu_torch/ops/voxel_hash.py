"""Voxel-hash spatial index for the gated 5-NN — port of
``lvislam_tpu.ops.voxel_hash``.

Bucket storage is bit-identical to the JAX tables: component-planar int16
rows ``rel (T, 4, B)`` = ``[B·x | B·y | B·z | B·tag]`` with cell-relative
fixed-point positions (2048 steps per cell) and an 11-bit secondary cell
tag (-1 marks an empty lane), ``cnt (T,)`` int32 and ``idx (T, B)`` int32
indices into the original point array.

Query paths:

- ``query``: gather the 27 neighbouring buckets, score, stable top-k — plain
  PyTorch, the reference the kernel is held to;
- ``query_gather`` + ``query_score``: gather once, re-score at updated query
  positions through kernel K1 (``ops.knn_tail``); ``query_score_pair`` does
  two hashes' in one launch;
- ``query_fused``: both at once.

All score candidates in the same scaled domain with the same f32 op order,
so the paths select identically.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import knn_tail as _knn_tail
from .segment import set_rows

_BIG = 1e10
_QUANT = 2048.0
_M32 = 0xFFFFFFFF


class VoxelHash(NamedTuple):
    rel: torch.Tensor  # (T, 4, B) int16 planar [x|y|z|tag]
    cnt: torch.Tensor  # (T,) int32 points per bucket
    cell: torch.Tensor  # () float32 cell size
    idx: torch.Tensor  # (T, B) int32 global indices


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for int64 `a` in [0, 2^32), in 16-bit halves so no
    intermediate leaves int64."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u32(c: torch.Tensor) -> torch.Tensor:
    """int32 -> its uint32 bit pattern, held in int64."""
    return c.to(torch.int64) & _M32


def _slot(cx, cy, cz, table_size: int) -> torch.Tensor:
    h = (_mul32(_u32(cx), 73856093) ^ _mul32(_u32(cy), 19349669)
         ^ _mul32(_u32(cz), 83492791))
    return (h & (table_size - 1)).to(torch.int32)


def _tag(cx, cy, cz) -> torch.Tensor:
    """Secondary 11-bit cell hash, combined additively (see the JAX module
    for why not XOR)."""
    h = (_mul32(_u32(cx), 2654435761) + _mul32(_u32(cy), 1013904223)
         + _mul32(_u32(cz), 374761393)) & _M32
    h = h ^ (h >> 15)
    return (h & 2047).to(torch.int32)


def _run_rank(s: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal sorted keys."""
    n = s.shape[0]
    ar = torch.arange(n, device=s.device)
    is_new = torch.ones(n, dtype=torch.bool, device=s.device)
    is_new[1:] = s[1:] != s[:-1]
    run_start = torch.cummax(torch.where(is_new, ar, torch.zeros_like(ar)), 0).values
    return ar - run_start


def _rel4(points, c, cell, order):
    tag = _tag(c[:, 0], c[:, 1], c[:, 2])
    rel_q = torch.round((points - c.to(points.dtype) * cell) * (_QUANT / cell)
                        ).to(torch.int16)
    return torch.cat([rel_q, tag[:, None].to(torch.int16)], dim=1)[order]


def build(points: torch.Tensor, valid: torch.Tensor, cell: float,
          table_size: int = 1 << 16, bucket_cap: int = 32) -> VoxelHash:
    """Sort points by slot (stable: the bucket rank decides which points
    overflow) and scatter them into bucketed planar storage."""
    M = points.shape[0]
    dev = points.device
    B, T = bucket_cap, table_size
    cell_t = torch.as_tensor(cell, dtype=points.dtype, device=dev)
    c = torch.floor(points / cell_t).to(torch.int32)
    slot = torch.where(valid, _slot(c[:, 0], c[:, 1], c[:, 2], T),
                       torch.full((M,), T, dtype=torch.int32, device=dev))
    srt = torch.sort(slot, stable=True)
    order, s_sorted = srt.indices, srt.values.long()
    rank = _run_rank(s_sorted)
    keep = (s_sorted < T) & (rank < B)
    base = torch.where(keep, s_sorted * (4 * B) + rank, torch.full_like(rank, -1))

    rel4 = _rel4(points, c, cell_t, order)
    dst = base[:, None] + torch.arange(4, device=dev) * B  # -1 rows drop
    dst = torch.where(base[:, None] >= 0, dst, torch.full_like(dst, -1))
    flat = set_rows(torch.full((T * 4 * B,), -1, dtype=torch.int16, device=dev),
                    dst.reshape(-1), rel4.reshape(-1))
    dsti = torch.where(keep, s_sorted * B + rank, torch.full_like(rank, -1))
    idx = set_rows(torch.full((T * B,), -1, dtype=torch.int32, device=dev),
                   dsti, order.to(torch.int32))
    cnt = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, torch.clamp(s_sorted, max=T), keep.to(torch.int32))
    return VoxelHash(rel=flat.reshape(T, 4, B), cnt=cnt[:-1], cell=cell_t,
                     idx=idx.reshape(T, B))


def insert(h: VoxelHash, points: torch.Tensor, valid: torch.Tensor,
           global_idx: torch.Tensor) -> VoxelHash:
    """Incremental scatter-insert of new points (the keyframe-rate
    alternative to a full ``build``); bucket overflow drops like ``build``."""
    T, _, B = h.rel.shape
    N = points.shape[0]
    dev = points.device
    c = torch.floor(points / h.cell).to(torch.int32)
    slot = torch.where(valid, _slot(c[:, 0], c[:, 1], c[:, 2], T),
                       torch.full((N,), T, dtype=torch.int32, device=dev))
    srt = torch.sort(slot, stable=True)
    order, s = srt.indices, srt.values.long()
    rank = h.cnt[torch.clamp(s, max=T - 1)].long() + _run_rank(s)
    keep = (s < T) & (rank < B)

    rel4 = _rel4(points, c, h.cell, order)
    base_dst = torch.where(keep, s * (4 * B) + rank, torch.full_like(rank, -1))
    dst = base_dst[:, None] + torch.arange(4, device=dev) * B
    dst = torch.where(base_dst[:, None] >= 0, dst, torch.full_like(dst, -1))
    rel_flat = set_rows(h.rel.reshape(-1), dst.reshape(-1), rel4.reshape(-1))
    dsti = torch.where(keep, s * B + rank, torch.full_like(rank, -1))
    idx_flat = set_rows(h.idx.reshape(-1), dsti, global_idx[order].to(torch.int32))
    cnt = torch.cat([h.cnt, torch.zeros(1, dtype=torch.int32, device=dev)])
    cnt.index_add_(0, torch.clamp(s, max=T), keep.to(torch.int32))
    return VoxelHash(rel=rel_flat.reshape(T, 4, B), cnt=cnt[:-1], cell=h.cell,
                     idx=idx_flat.reshape(T, B))


_OFFS27 = np.stack(np.meshgrid(
    np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2), indexing="ij",
), -1).reshape(27, 3).astype(np.int32)


def _neighborhood(h: VoxelHash, queries: torch.Tensor):
    """(Q,27) slots, wanted tags, and the scaled geometry: query positions
    and cell corners in fixed-point steps, the domain both paths score in."""
    T = h.rel.shape[0]
    qc = torch.floor(queries / h.cell).to(torch.int32)
    offs = torch.as_tensor(_OFFS27, device=queries.device)
    cells = qc[:, None, :] + offs[None, :, :]  # (Q, 27, 3)
    slots = _slot(cells[..., 0], cells[..., 1], cells[..., 2], T)
    want_tag = _tag(cells[..., 0], cells[..., 1], cells[..., 2])
    corner_s = cells.to(torch.float32) * _QUANT
    q_s = queries.to(torch.float32) * (_QUANT / h.cell)
    return slots, want_tag, corner_s, q_s


def _recover_idx(h: VoxelHash, slots: torch.Tensor, pos: torch.Tensor, B: int):
    """Flat candidate positions (j*B + rank) -> global indices (-1 beyond
    the candidate range)."""
    in_range = pos < 27 * B
    pos = torch.clamp(pos, max=27 * B - 1).long()
    j = torch.div(pos, B, rounding_mode="floor")
    rank = pos % B
    sel_slot = torch.gather(slots, 1, j).long()
    return torch.where(in_range, h.idx[sel_slot, rank],
                       torch.full_like(pos, -1, dtype=torch.int32))


def _finish(h: VoxelHash, slots, dist_s, pos, B: int):
    out_idx = _recover_idx(h, slots, pos, B)
    scale2 = (h.cell / _QUANT) ** 2
    # masked lanes keep the _BIG sentinel (not rescaled)
    return out_idx, torch.where(dist_s >= _BIG, torch.full_like(dist_s, _BIG),
                                dist_s * scale2)


def query(h: VoxelHash, queries: torch.Tensor, k: int = 5):
    """Gated k-NN: (idx (Q,k) into the original point array, approximate
    sqdist (Q,k)); neighbours beyond the 27-cell reach report _BIG."""
    T, _, B = h.rel.shape
    Q = queries.shape[0]
    slots, want_tag, corner_s, q_s = _neighborhood(h, queries)
    cand = h.rel[slots.long()]  # (Q, 27, 4, B) int16 — the big gather
    occ = cand[:, :, 3, :].to(torch.int32) == want_tag[..., None]
    off = corner_s - q_s[:, None, :]  # (Q, 27, 3)
    dx = cand[:, :, 0, :].to(torch.float32) + off[:, :, 0, None]
    dy = cand[:, :, 1, :].to(torch.float32) + off[:, :, 1, None]
    dz = cand[:, :, 2, :].to(torch.float32) + off[:, :, 2, None]
    d = dx * dx + dy * dy + dz * dz
    d = torch.where(occ, d, torch.full_like(d, _BIG)).reshape(Q, 27 * B)
    # lax.top_k breaks ties to the lowest index: a stable ascending sort
    srt = torch.sort(d, dim=1, stable=True)
    return _finish(h, slots, srt.values[:, :k], srt.indices[:, :k], B)


class GatheredCandidates(NamedTuple):
    """One (Q, 27)-neighbourhood gather, reusable across GN iterations."""

    slots: torch.Tensor  # (Q, 27) int32
    want_tag: torch.Tensor  # (Q, 27) int32
    corner_s: torch.Tensor  # (Q, 27, 3) scaled cell corners
    cand: torch.Tensor  # (Q, 27*4*B) int16 planar rows


def query_gather(h: VoxelHash, queries: torch.Tensor) -> GatheredCandidates:
    """The gather half of ``query_fused``: fetch the (Q, 27) bucket rows."""
    T, _, B = h.rel.shape
    Q = queries.shape[0]
    slots, want_tag, corner_s, _ = _neighborhood(h, queries)
    cand = h.rel[slots.long()].reshape(Q, 27 * 4 * B)
    return GatheredCandidates(slots=slots, want_tag=want_tag,
                              corner_s=corner_s, cand=cand)


def _query_set(h: VoxelHash, g: GatheredCandidates, queries: torch.Tensor):
    """K1's (cand, want_tag, corner_off, bucket) for cached candidates."""
    q_s = queries.to(torch.float32) * (_QUANT / h.cell)
    corner_off = (g.corner_s - q_s[:, None, :]).permute(0, 2, 1).reshape(-1, 81)
    return g.cand, g.want_tag, corner_off, h.rel.shape[2]


def query_score(h: VoxelHash, g: GatheredCandidates, queries: torch.Tensor,
                k: int = 5):
    """Score cached candidates against updated query positions (kernel K1
    on the card). Exact for queries still inside their gather-time cell."""
    qs = _query_set(h, g, queries)
    dist_s, pos = _knn_tail.knn_tail(*qs, k=k)
    return _finish(h, g.slots, dist_s, pos, qs[3])


def query_score_pair(h_a: VoxelHash, g_a: GatheredCandidates, q_a: torch.Tensor,
                     h_b: VoxelHash, g_b: GatheredCandidates, q_b: torch.Tensor,
                     k: int = 5):
    """``query_score`` of two hashes' cached candidates in one launch of
    kernel K1; returns ((idx_a, sqdist_a), (idx_b, sqdist_b))."""
    a, b = _query_set(h_a, g_a, q_a), _query_set(h_b, g_b, q_b)
    (da, pa), (db, pb) = _knn_tail.knn_tail_pair(a, b, k=k)
    return _finish(h_a, g_a.slots, da, pa, a[3]), _finish(h_b, g_b.slots, db, pb, b[3])


def query_fused(h: VoxelHash, queries: torch.Tensor, k: int = 5):
    """``query`` with the post-gather tail in kernel K1."""
    return query_score(h, query_gather(h, queries), queries, k=k)
