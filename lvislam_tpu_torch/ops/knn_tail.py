"""Kernel K1: voxel-hash candidate scoring + top-k.

Replaces the TPU kernel ``lvislam_tpu/ops/pallas_knn.py:79 topk_tail``
(body ``_tail_kernel``). It computes what that kernel computes, not its lane
layout: for each query, over the 27 cells × B bucket lanes of cell-relative
int16 candidates, the scaled offset ``cand + (corner - q)``, the tag match
(which is also the occupancy mask), the squared distance summed x, y, z in
that order, and the k smallest (distance, flat position ``j*B + rank``)
pairs, ties to the lowest position — exactly ``lax.top_k`` over the flat
candidate axis, as ``voxel_hash.query`` selects.

CUDA design (``csrc/knn_tail.cu``): one warp per query. Each lane owns the
flat positions ``lane, lane+32, ...`` (at most 27 of them, kept in
registers), reads the planar int16 x/y/z/tag straight from the gathered
row, and scores them with non-contracted f32 ops in the plain version's
order. Then k rounds of a warp-shuffle argmin on (distance, position); the
winner's owner marks it spent. What bounds it on the card: the read of the
gathered rows (Q·27·4·B int16, 7 MB at Q=2048, B=16) — one pass, no
intermediate distance tensor in device memory.
"""

from __future__ import annotations

import torch

from . import _kernels

_BIG = 1e10

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke reads it)


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


def _launch(cand, want_tag, corner_off, bucket: int, k: int):
    global LAUNCHES
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
    for t in (want_tag, corner_off):
        if t.device != cand.device:
            raise ValueError("knn_tail: inputs on different devices")
    cand, want_tag, corner_off = (cand.contiguous(), want_tag.contiguous(),
                                  corner_off.contiguous())
    dist = torch.empty((Q, k), dtype=torch.float32, device=cand.device)
    pos = torch.empty((Q, k), dtype=torch.int32, device=cand.device)
    if Q == 0:
        return dist, pos
    lib = _kernels.library()
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = lib.lvt_knn_tail(cand.data_ptr(), want_tag.data_ptr(),
                           corner_off.data_ptr(), dist.data_ptr(),
                           pos.data_ptr(), Q, bucket, k, stream)
    _kernels.check(err, "lvt_knn_tail")
    LAUNCHES += 1
    return dist, pos


def knn_tail(cand: torch.Tensor, want_tag: torch.Tensor,
             corner_off: torch.Tensor, bucket: int, k: int = 5):
    """Fused distance + tag mask + top-k over gathered candidates.

    cand (Q, 27*4*B) int16 planar bucket rows, want_tag (Q, 27) int32,
    corner_off (Q, 81) f32 scaled ``[27 cx | 27 cy | 27 cz] - query``.
    Returns (dist (Q,k) f32, pos (Q,k) int32). A CPU tensor takes the plain
    version; a CUDA tensor launches kernel K1."""
    if cand.device.type == "cpu":
        return knn_tail_plain(cand, want_tag, corner_off, bucket, k)
    if cand.device.type != "cuda":
        raise ValueError(f"knn_tail: unsupported device {cand.device}")
    return _launch(cand, want_tag, corner_off, bucket, k)
