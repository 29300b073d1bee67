"""Visual loop detection — port of ``lvislam_tpu.models.loop.loop_detector``
(the pose_graph package's `LoopDetector::addKeyFrame`,
`loop_detector.cpp:12-135`, `keyframe.cpp:37-263`).

Per keyframe: extra Shi-Tomasi corners and BRIEF descriptors of them and of
the tracked window points; a BoW query against the database with the most
recent frames excluded (accept a top score over 0.05 with a second over
0.015, the earliest qualifying keyframe wins); then geometric verification
(Hamming < 80 matches of the window points against the old keyframe's
corners, PnP RANSAC over more than `min_loop_matches` inliers); last, the
insert into a fixed-capacity ring.

The top four scores come from a stable descending sort, so ties go to the
lower slot as with ``lax.top_k``, whatever order ``torch.topk`` would give
on the card. JAX's ``lax.cond(has_cand, verify, no)`` is a host branch here:
one read (``core.hostsync``) a keyframe, and verification runs only for a
candidate. The database is updated in place (indexed copies with device
indices: no read) and returned.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ...core.device import resolve as resolve_device
from ...core.hostsync import host_bool
from ...ops import brief, gftt, ransac


@dataclasses.dataclass(frozen=True)
class LoopCaps:
    max_keyframes: int = 1024
    window_points: int = 150  # tracked-feature keypoints per keyframe
    extra_points: int = 256  # FAST/Shi-Tomasi keypoints per keyframe
    vocab_words: int = 1024
    recent_exclude: int = 200  # frames excluded from query (`loop_detector.cpp:67`)
    min_loop_matches: int = 25  # MIN_LOOP_NUM (`keyframe.h:16`)


class LoopDB(NamedTuple):
    """Fixed-capacity ring: slot = insert number % N; `seq` holds each
    slot's insert number (-1 = never written), so the recency exclusion
    stays right after wraparound."""

    bags: torch.Tensor  # (N, V) BoW vectors
    kp_desc: torch.Tensor  # (N, E, 256) extra-keypoint descriptors (±1)
    kp_valid: torch.Tensor  # (N, E)
    kp_norm: torch.Tensor  # (N, E, 2) normalized coords of extra keypoints
    stamps: torch.Tensor  # (N,)
    count: torch.Tensor  # () int32 total inserts ever (not clamped to N)
    seq: torch.Tensor  # (N,) int32 insert number held by each slot, -1 if empty
    vocab: torch.Tensor  # (V, 256)
    idf: torch.Tensor  # (V,) tf-idf word weights (ones for untrained vocab)


def db_init(caps: LoopCaps, dtype=torch.float32, vocab=None, idf=None,
            device=None) -> LoopDB:
    """The empty database on `device` (the card unless named). `vocab` /
    `idf` from `brief.train_vocabulary` / `load_vocabulary`; without them
    the seeded random vocabulary with uniform weights."""
    device = resolve_device(device)
    N, E, V = caps.max_keyframes, caps.extra_points, caps.vocab_words
    if vocab is None:
        vocab = brief.make_vocabulary(V)
    if idf is None:
        idf = np.ones(V, np.float32)
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return LoopDB(
        bags=z(N, V),
        kp_desc=z(N, E, brief.N_BITS),
        kp_valid=torch.zeros((N, E), dtype=torch.bool, device=device),
        kp_norm=z(N, E, 2),
        stamps=z(N),
        count=torch.zeros((), dtype=torch.int32, device=device),
        seq=torch.full((N,), -1, dtype=torch.int32, device=device),
        vocab=torch.as_tensor(np.asarray(vocab), dtype=dtype, device=device),
        idf=torch.as_tensor(np.asarray(idf), dtype=dtype, device=device),
    )


class LoopCandidate(NamedTuple):
    found: torch.Tensor  # () bool
    old_index: torch.Tensor  # () keyframe slot in the DB
    cur_index: torch.Tensor  # () insert number of the current keyframe
    rel_trans: torch.Tensor  # (3,) old_cam <- cur frame PnP pose
    rel_quat: torch.Tensor  # (4,)
    n_matches: torch.Tensor  # () PnP inliers
    best_score: torch.Tensor  # ()


def add_and_detect(
    db: LoopDB,
    image: torch.Tensor,  # (H, W) float in [0, 1]
    win_uv: torch.Tensor,  # (Wp, 2) tracked window points (pixels)
    win_norm: torch.Tensor,  # (Wp, 2) their normalized coords
    win_pts3d: torch.Tensor,  # (Wp, 3) world points (current VIO frame)
    win_valid: torch.Tensor,  # (Wp,)
    stamp,
    caps: LoopCaps,
    focal: float = 460.0,
    center: torch.Tensor | None = None,
    sampler=None,  # PnP draws: sampler(weights, n_hyp, 6) -> (n_hyp, 6) indices
) -> tuple[LoopDB, LoopCandidate]:
    """`addKeyFrame`: query first, then insert (`loop_detector.cpp:12-53`)."""
    dev = image.device
    H, W = image.shape
    kp, kp_ok = gftt.detect(
        image, torch.zeros((1, 2), dtype=image.dtype, device=dev),
        torch.zeros(1, dtype=torch.bool, device=dev),
        max_pts=caps.extra_points, cell=12, border=16,
    )
    kp_desc = brief.describe(image, kp, kp_ok)
    c = (torch.tensor([W / 2.0, H / 2.0], dtype=image.dtype, device=dev)
         if center is None else center)
    kp_norm = (kp - c) / focal

    win_desc = brief.describe(image, win_uv, win_valid)
    bag = brief.bow_vector(torch.cat([win_desc, kp_desc]), torch.cat([win_valid, kp_ok]),
                           db.vocab, idf=db.idf)

    # ---- query, excluding recent frames (ring-aware through `seq`) ----
    n = db.count
    scores = brief.bow_scores(bag, db.bags)
    eligible = (db.seq >= 0) & (db.seq < n - caps.recent_exclude)
    scores = torch.where(eligible, scores, torch.full_like(scores, -1.0))
    srt = torch.sort(scores, descending=True, stable=True)
    top4, top_idx = srt.values[:4], srt.indices[:4]
    above = top4 > 0.015
    good = (top4[0] > 0.05) & torch.any(above[1:])
    # earliest qualifying frame among candidates above 0.015 (insert order)
    qual_seq = torch.where(above, db.seq[top_idx], torch.full_like(top_idx, 2**30,
                                                                   dtype=torch.int32))
    old_idx = top_idx[torch.argmin(qual_seq)]
    has_cand = good & torch.any(above)

    if host_bool(has_cand):
        midx, mok = brief.match(win_desc, win_valid, db.kp_desc[old_idx], db.kp_valid[old_idx])
        matched_old = db.kp_norm[old_idx][midx.long()]
        n_match = torch.sum(mok)
        idx = None if sampler is None else sampler(ransac.hypothesis_weights(mok), 128, 6)
        res = ransac.pnp_ransac(win_pts3d, matched_old, mok, threshold=10.0 / focal,
                                n_hyp=128, idx=idx)
        cand = LoopCandidate(
            found=(n_match > caps.min_loop_matches) & (res.n_inliers > caps.min_loop_matches),
            old_index=old_idx.to(torch.int32), cur_index=n, rel_trans=res.trans,
            rel_quat=res.quat, n_matches=res.n_inliers.to(torch.int32), best_score=top4[0],
        )
    else:
        cand = LoopCandidate(
            found=torch.zeros((), dtype=torch.bool, device=dev),
            old_index=torch.full((), -1, dtype=torch.int32, device=dev), cur_index=n,
            rel_trans=torch.zeros(3, dtype=image.dtype, device=dev),
            rel_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=image.dtype, device=dev),
            n_matches=torch.zeros((), dtype=torch.int32, device=dev), best_score=top4[0],
        )

    # ---- insert (after the query, `loop_detector.cpp:46`); at capacity the
    # oldest entry is evicted ----
    k = (n % caps.max_keyframes).long()[None]
    db.bags.index_copy_(0, k, bag[None])
    db.kp_desc.index_copy_(0, k, kp_desc[None])
    db.kp_valid.index_copy_(0, k, kp_ok[None])
    db.kp_norm.index_copy_(0, k, kp_norm[None])
    db.stamps.index_copy_(0, k, torch.as_tensor(stamp, dtype=db.stamps.dtype, device=dev)[None])
    db.seq.index_copy_(0, k, n[None])
    return db._replace(count=n + 1), cand
