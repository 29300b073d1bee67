"""Kernel K1: voxel-hash candidate scoring + top-k, for two query sets in
one launch.

Replaces the TPU kernel ``lvislam_tpu/ops/pallas_knn.py:79 topk_tail``
(body ``_tail_kernel``), which the JAX step calls once per feature class.
It computes what that kernel computes, not its lane layout: for each query,
over the 27 cells × B bucket lanes of cell-relative int16 candidates, the
scaled offset ``cand + (corner - q)``, the tag match (which is also the
occupancy mask), the squared distance summed x, y, z in that order, and the
k smallest (distance, flat position ``j*B + rank``) pairs, ties to the
lowest position — exactly ``lax.top_k`` over the flat candidate axis, as
``voxel_hash.query`` selects.

CUDA design (``csrc/knn_tail.cu``): one grid over both query sets
(``knn_tail_pair``: the LIO step's corner and surf classes) of persistent
warps, each looping over queries. At B = 16 and 32 (compiled as constants)
a warp stages its query's row in shared memory with one ``cp.async.bulk``
copy completed on an mbarrier (want_tag and corner_off with 4-byte
``cp.async`` copies), scores it from there — each lane 8 consecutive ranks
of a cell from one 16-byte vector of each of the x, y, z and tag planes —
and then starts the next query's copies, which stream in while it selects.
Any other B reads one candidate at a time, one warp a query. Each lane scores its positions
with non-contracted f32 ops in the plain version's order; then k rounds of
a lane-local tree argmin and two warp-wide ``redux.sync`` minima on
(distance, position). What bounds it on the card: the one read of the
gathered rows (Q·27·4·B int16: 11.8 MB for the step's pair, 3.5 µs at HBM
rate). At B = 16 and 32 the rows must start on a 16-byte boundary: the
wrapper refuses a view that does not.

``knn_tail_batched`` is K1 over S sequences at once, the form JAX's
``vmap`` of the step gives the TPU kernel (its batching rule adds a batch
axis to the grid, ``pallas_knn.py:112``). Queries are independent, so it
is the same launch over each class's S·Q rows stacked sequence by
sequence; a row is 27·4·B int16 (3,456 or 6,912 bytes at B = 16 or 32, a
multiple of 16), so every row of a contiguous stack keeps the 16-byte
alignment of its first. The persistent grid is ``min(blocks, resident)``
blocks whatever the query count, each warp taking queries a grid stride
apart, so S·Q past one wave needs nothing else.
"""

from __future__ import annotations

import torch

from ..core.device import common
from . import _kernels

_BIG = 1e10

LAUNCHES = 0  # kernel launches since the last reset, whatever S (chip_smoke reads it)


def knn_tail_plain(cand: torch.Tensor, want_tag: torch.Tensor,
                   corner_off: torch.Tensor, bucket: int, k: int = 5):
    """Plain PyTorch version: (dist (Q,k) f32 scaled sqdist, pos (Q,k)
    int32 flat position j*B + rank)."""
    Q = cand.shape[0]
    B = bucket
    c = cand.reshape(Q, 27, 4, B)
    off = corner_off.reshape(Q, 3, 27)
    dx = c[:, :, 0, :].to(torch.float32) + off[:, 0, :, None]
    dy = c[:, :, 1, :].to(torch.float32) + off[:, 1, :, None]
    dz = c[:, :, 2, :].to(torch.float32) + off[:, 2, :, None]
    d = dx * dx + dy * dy + dz * dz
    occ = c[:, :, 3, :].to(torch.int32) == want_tag[:, :, None]
    d = torch.where(occ, d, torch.full_like(d, _BIG)).reshape(Q, 27 * B)
    srt = torch.sort(d, dim=1, stable=True)
    return (torch.clamp(srt.values[:, :k], max=_BIG),
            srt.indices[:, :k].to(torch.int32))


def knn_tail_pair_plain(a, b, k: int = 5):
    """Plain PyTorch version of ``knn_tail_pair``: one ``knn_tail_plain``
    per query set."""
    return knn_tail_plain(*a, k=k), knn_tail_plain(*b, k=k)


def _checked(cand, want_tag, corner_off, bucket: int, k: int):
    """The set's tensors made contiguous, with fresh (dist, pos) outputs."""
    Q = cand.shape[0]
    if cand.dtype != torch.int16 or want_tag.dtype != torch.int32 \
            or corner_off.dtype != torch.float32:
        raise TypeError("knn_tail: expects int16 cand, int32 want_tag, "
                        "float32 corner_off")
    if cand.shape != (Q, 27 * 4 * bucket) or want_tag.shape != (Q, 27) \
            or corner_off.shape != (Q, 81):
        raise ValueError("knn_tail: bad shapes "
                         f"{tuple(cand.shape)} {tuple(want_tag.shape)} "
                         f"{tuple(corner_off.shape)} for B={bucket}")
    if not (1 <= bucket <= 32 and 1 <= k <= 27 * bucket):
        raise ValueError(f"knn_tail: unsupported B={bucket}, k={k}")
    cand, want_tag, corner_off = (cand.contiguous(), want_tag.contiguous(),
                                  corner_off.contiguous())
    if bucket in (16, 32) and cand.data_ptr() % 16:  # the kernel's vector loads
        raise ValueError("knn_tail: candidate rows must start on a 16-byte "
                         f"boundary (address {cand.data_ptr():#x})")
    dist = torch.empty((Q, k), dtype=torch.float32, device=cand.device)
    pos = torch.empty((Q, k), dtype=torch.int32, device=cand.device)
    return cand, want_tag, corner_off, dist, pos


def _launch(sets, k: int):
    """One K1 launch over one or two (cand, want_tag, corner_off, bucket)
    query sets; returns [(dist, pos)] per set."""
    global LAUNCHES
    args = [_checked(*qs, k) for qs in sets]
    dev = args[0][0].device
    if sum(a[0].shape[0] for a in args) > 0:
        ptrs = []
        for (cand, want_tag, corner_off, dist, pos), qs in zip(args, sets):
            ptrs += [cand.data_ptr(), want_tag.data_ptr(), corner_off.data_ptr(),
                     dist.data_ptr(), pos.data_ptr(), cand.shape[0], qs[3]]
        if len(sets) == 1:
            ptrs += [None] * 5 + [0, 0]
        lib = _kernels.library()
        with torch.cuda.device(dev):  # launch on the inputs' card
            stream = torch.cuda.current_stream(dev).cuda_stream
            _kernels.check(lib.lvt_knn_tail_pair(*ptrs, k, stream), "lvt_knn_tail_pair")
        LAUNCHES += 1
    return [(a[3], a[4]) for a in args]


def knn_tail_pair(a, b, k: int = 5):
    """``knn_tail`` of two query sets ``a`` and ``b``, each (cand,
    want_tag, corner_off, bucket), in one launch of kernel K1. Returns
    ((dist_a, pos_a), (dist_b, pos_b)). Tensors all on the CPU take the
    plain version; tensors all on the card launch the kernel; any mix
    raises."""
    dev = common([*a[:3], *b[:3]], "knn_tail")
    if dev.type == "cpu":
        return knn_tail_pair_plain(a, b, k)
    if dev.type != "cuda":
        raise ValueError(f"knn_tail: unsupported device {dev}")
    ra, rb = _launch([a, b], k)
    return ra, rb


def knn_tail(cand: torch.Tensor, want_tag: torch.Tensor,
             corner_off: torch.Tensor, bucket: int, k: int = 5):
    """Fused distance + tag mask + top-k over gathered candidates.

    cand (Q, 27*4*B) int16 planar bucket rows, want_tag (Q, 27) int32,
    corner_off (Q, 81) f32 scaled ``[27 cx | 27 cy | 27 cz] - query``.
    Returns (dist (Q,k) f32, pos (Q,k) int32). A CPU tensor takes the plain
    version; a CUDA tensor launches kernel K1 with this one query set."""
    dev = common((cand, want_tag, corner_off), "knn_tail")
    if dev.type == "cpu":
        return knn_tail_plain(cand, want_tag, corner_off, bucket, k)
    if dev.type != "cuda":
        raise ValueError(f"knn_tail: unsupported device {dev}")
    return _launch([(cand, want_tag, corner_off, bucket)], k)[0]


def knn_tail_batched(sets, S: int, k: int = 5):
    """K1 over S sequences: each of the one or two query sets of ``sets``
    is (cand (S·Q, 27·4·B), want_tag (S·Q, 27), corner_off (S·Q, 81),
    bucket) with sequence s's rows at [s·Q, (s+1)·Q). Returns [(dist
    (S, Q, k), pos (S, Q, k))] a set, each sequence's rows equal to its own
    ``knn_tail`` call. Tensors all on the CPU take the plain version;
    tensors all on the card launch the kernel once for all sets and
    sequences; any mix raises."""
    if not 1 <= len(sets) <= 2:
        raise ValueError(f"knn_tail_batched: one or two query sets, not {len(sets)}")
    dev = common([t for qs in sets for t in qs[:3]], "knn_tail_batched")
    for qs in sets:
        if S < 1 or qs[0].shape[0] % S:
            raise ValueError(f"knn_tail_batched: {qs[0].shape[0]} rows are not "
                             f"{S} sequences of equal size")
    if dev.type == "cpu":
        res = [knn_tail_plain(*qs, k=k) for qs in sets]
    elif dev.type == "cuda":
        res = _launch(sets, k)
    else:
        raise ValueError(f"knn_tail_batched: unsupported device {dev}")
    return [(d.reshape(S, -1, k), p.reshape(S, -1, k)) for d, p in res]
