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

The ``*_batched`` forms take a hash whose leaves carry a leading sequence
axis S (``rel (S, T, 4, B)``, ``cnt (S, T)``, ``cell (S,)``, ``idx
(S, T, B)``: the batched LIO state's) and queries (S, Q, 3), and give each
sequence what it gets alone, bit for bit. A sequence's slots index the
flattened (S·T) table at ``s·T + slot``, so one gather and one K1 launch
serve all S sequences (``query_score_pair_batched``: both classes too). The
one-sequence functions above are their case S = 1 (views of a batch of
one).
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


def _cells(queries: torch.Tensor, cell: torch.Tensor, T: int):
    """(..., 27) slots, wanted tags, and the cell corners in fixed-point
    steps, the domain every path scores in. `cell` broadcasts against
    `queries`."""
    qc = torch.floor(queries / cell).to(torch.int32)
    offs = torch.as_tensor(_OFFS27, device=queries.device)
    cells = qc[..., None, :] + offs  # (..., 27, 3)
    slots = _slot(cells[..., 0], cells[..., 1], cells[..., 2], T)
    want_tag = _tag(cells[..., 0], cells[..., 1], cells[..., 2])
    corner_s = cells.to(torch.float32) * _QUANT
    return slots, want_tag, corner_s


def _recover_idx(idx_table: torch.Tensor, slots: torch.Tensor, pos: torch.Tensor, B: int):
    """Flat candidate positions (j*B + rank) -> global indices (-1 beyond
    the candidate range); `slots` (Q, 27) are rows of `idx_table`."""
    in_range = pos < 27 * B
    pos = torch.clamp(pos, max=27 * B - 1).long()
    j = torch.div(pos, B, rounding_mode="floor")
    rank = pos % B
    sel_slot = torch.gather(slots, 1, j).long()
    return torch.where(in_range, idx_table[sel_slot, rank],
                       torch.full_like(pos, -1, dtype=torch.int32))


def _rescale(dist_s, scale2):
    # masked lanes keep the _BIG sentinel (not rescaled)
    return torch.where(dist_s >= _BIG, torch.full_like(dist_s, _BIG), dist_s * scale2)


def _topk_plain(cand, want_tag, corner_s, q_s, B: int, k: int):
    """The plain scoring of gathered rows cand (Q, 27, 4, B): scaled
    distances, the tag mask, and the stable top-k (values, positions)."""
    Q = cand.shape[0]
    occ = cand[:, :, 3, :].to(torch.int32) == want_tag[..., None]
    off = corner_s - q_s[:, None, :]  # (Q, 27, 3)
    dx = cand[:, :, 0, :].to(torch.float32) + off[:, :, 0, None]
    dy = cand[:, :, 1, :].to(torch.float32) + off[:, :, 1, None]
    dz = cand[:, :, 2, :].to(torch.float32) + off[:, :, 2, None]
    d = dx * dx + dy * dy + dz * dz
    d = torch.where(occ, d, torch.full_like(d, _BIG)).reshape(Q, 27 * B)
    # lax.top_k breaks ties to the lowest index: a stable ascending sort
    srt = torch.sort(d, dim=1, stable=True)
    return srt.values[:, :k], srt.indices[:, :k]


class GatheredCandidates(NamedTuple):
    """One (Q, 27)-neighbourhood gather, reusable across GN iterations."""

    slots: torch.Tensor  # (Q, 27) int32
    want_tag: torch.Tensor  # (Q, 27) int32
    corner_s: torch.Tensor  # (Q, 27, 3) scaled cell corners
    cand: torch.Tensor  # (Q, 27*4*B) int16 planar rows


# ---- S sequences at once (hash leaves and queries with a leading S axis) ----

def _batch_cell(h: VoxelHash) -> torch.Tensor:
    return h.cell.reshape(-1, 1, 1)


def _scaled_queries(h: VoxelHash, queries: torch.Tensor) -> torch.Tensor:
    """(S·Q, 3) query positions in fixed-point steps, the cell corners'."""
    return (queries.to(torch.float32) * (_QUANT / _batch_cell(h))).reshape(-1, 3)


def query_gather_batched(h: VoxelHash, queries: torch.Tensor) -> GatheredCandidates:
    """``query_gather`` of S sequences, queries (S, Q, 3): the candidates
    of sequence s at rows [s·Q, (s+1)·Q), its slots as rows s·T + slot of
    the flattened (S·T) table."""
    S, T, _, B = h.rel.shape
    slots, want_tag, corner_s = _cells(queries, _batch_cell(h), T)
    base = torch.arange(0, S * T, T, dtype=torch.int32, device=slots.device)
    rows = (slots + base[:, None, None]).reshape(-1, 27)
    cand = h.rel.reshape(S * T, 4, B)[rows.long()].reshape(rows.shape[0], 27 * 4 * B)
    return GatheredCandidates(slots=rows, want_tag=want_tag.reshape(-1, 27),
                              corner_s=corner_s.reshape(-1, 27, 3), cand=cand)


def _query_set_batched(h: VoxelHash, g: GatheredCandidates, queries: torch.Tensor):
    """K1's stacked (cand, want_tag, corner_off, bucket) for S sequences."""
    q_s = _scaled_queries(h, queries)
    corner_off = (g.corner_s - q_s[:, None, :]).permute(0, 2, 1).reshape(-1, 81)
    return g.cand, g.want_tag, corner_off, h.rel.shape[3]


def _finish_batched(h: VoxelHash, rows, dist_s, pos, B: int):
    """K1's (or the plain top-k's) output of S sequences, dist_s and pos
    (S, Q, k), as (global indices, sqdist); `rows` are the flattened
    table's (S·Q, 27) slots."""
    S, Q, k = pos.shape
    idx = _recover_idx(h.idx.reshape(-1, B), rows, pos.reshape(S * Q, k), B)
    return idx.reshape(S, Q, k), _rescale(dist_s, ((h.cell / _QUANT) ** 2)[:, None, None])


def query_batched(h: VoxelHash, queries: torch.Tensor, k: int = 5):
    """``query`` of S sequences: (idx (S, Q, k), sqdist (S, Q, k))."""
    S, B = h.rel.shape[0], h.rel.shape[3]
    g = query_gather_batched(h, queries)
    d, p = _topk_plain(g.cand.reshape(-1, 27, 4, B), g.want_tag, g.corner_s,
                       _scaled_queries(h, queries), B, k)
    return _finish_batched(h, g.slots, d.reshape(S, -1, k), p.reshape(S, -1, k), B)


def query_score_batched(h: VoxelHash, g: GatheredCandidates, queries: torch.Tensor,
                        k: int = 5):
    """``query_score`` of S sequences in one launch of kernel K1."""
    qs = _query_set_batched(h, g, queries)
    (d, p), = _knn_tail.knn_tail_batched([qs], queries.shape[0], k=k)
    return _finish_batched(h, g.slots, d, p, qs[3])


def query_score_pair_batched(h_a: VoxelHash, g_a: GatheredCandidates, q_a: torch.Tensor,
                             h_b: VoxelHash, g_b: GatheredCandidates, q_b: torch.Tensor,
                             k: int = 5):
    """``query_score_pair`` of S sequences: both hashes' cached candidates
    for all S in one launch of kernel K1; returns ((idx_a, sqdist_a),
    (idx_b, sqdist_b)), each (S, Q, k)."""
    a, b = _query_set_batched(h_a, g_a, q_a), _query_set_batched(h_b, g_b, q_b)
    (da, pa), (db, pb) = _knn_tail.knn_tail_batched([a, b], q_a.shape[0], k=k)
    return (_finish_batched(h_a, g_a.slots, da, pa, a[3]),
            _finish_batched(h_b, g_b.slots, db, pb, b[3]))


def query_fused_batched(h: VoxelHash, queries: torch.Tensor, k: int = 5):
    """``query_fused`` of S sequences: one gather and one K1 launch."""
    return query_score_batched(h, query_gather_batched(h, queries), queries, k=k)


def stack(hashes) -> VoxelHash:
    """Per-sequence hashes of one size stacked into a batched hash."""
    return VoxelHash(*(torch.stack(x) for x in zip(*hashes)))


# ---- one sequence: the case S = 1 of the batched functions ----

def _one(h: VoxelHash) -> VoxelHash:
    """`h` as a batch of one sequence (views)."""
    return VoxelHash(*(x[None] for x in h))


def _first(res):
    return tuple(x[0] for x in res)


def query(h: VoxelHash, queries: torch.Tensor, k: int = 5):
    """Gated k-NN: (idx (Q,k) into the original point array, approximate
    sqdist (Q,k)); neighbours beyond the 27-cell reach report _BIG."""
    return _first(query_batched(_one(h), queries[None], k))


def query_gather(h: VoxelHash, queries: torch.Tensor) -> GatheredCandidates:
    """The gather half of ``query_fused``: fetch the (Q, 27) bucket rows."""
    return query_gather_batched(_one(h), queries[None])


def _query_set(h: VoxelHash, g: GatheredCandidates, queries: torch.Tensor):
    """K1's (cand, want_tag, corner_off, bucket) for cached candidates."""
    return _query_set_batched(_one(h), g, queries[None])


def query_score(h: VoxelHash, g: GatheredCandidates, queries: torch.Tensor,
                k: int = 5):
    """Score cached candidates against updated query positions (kernel K1
    on the card). Exact for queries still inside their gather-time cell."""
    return _first(query_score_batched(_one(h), g, queries[None], k))


def query_score_pair(h_a: VoxelHash, g_a: GatheredCandidates, q_a: torch.Tensor,
                     h_b: VoxelHash, g_b: GatheredCandidates, q_b: torch.Tensor,
                     k: int = 5):
    """``query_score`` of two hashes' cached candidates in one launch of
    kernel K1; returns ((idx_a, sqdist_a), (idx_b, sqdist_b))."""
    a, b = query_score_pair_batched(_one(h_a), g_a, q_a[None], _one(h_b), g_b, q_b[None], k)
    return _first(a), _first(b)


def query_fused(h: VoxelHash, queries: torch.Tensor, k: int = 5):
    """``query`` with the post-gather tail in kernel K1."""
    return _first(query_fused_batched(_one(h), queries[None], k))
