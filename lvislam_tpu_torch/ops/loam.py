"""LOAM feature extraction — port of ``lvislam_tpu.ops.loam``: the 5-point
curvature, the occlusion / parallel-beam mask, the sector bounds, the
vectorized edge selection (window non-max suppression + per-sector top-k)
the exact greedy ``select_edges`` (behind ``exact_loam_selection``) and
the surface candidates.
"""

from __future__ import annotations

import torch


def curvature(point_range: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """5-point curvature over the flat compacted range array (P,)."""
    r = torch.where(valid, point_range, torch.zeros_like(point_range))
    d = (
        torch.roll(r, 2) + torch.roll(r, 1) - 4.0 * r
        + torch.roll(r, -1) + torch.roll(r, -2)
    )
    return d * d


def occlusion_mask(point_range: torch.Tensor, col_ind: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """True where a point must NOT be picked (occluded or parallel beam)."""
    r = point_range
    rn = torch.roll(r, -1)
    col_diff = torch.abs(torch.roll(col_ind, -1) - col_ind)
    close = col_diff < 10
    mask_a = close & (r - rn > 0.3)
    picked = mask_a | torch.roll(mask_a, -1)
    mask_b = close & (rn - r > 0.3)
    picked = picked | torch.roll(mask_b, 1) | torch.roll(mask_b, 2)
    diff1 = torch.abs(torch.roll(r, 1) - r)
    diff2 = torch.abs(torch.roll(r, -1) - r)
    picked = picked | ((diff1 > 0.1 * r) & (diff2 > 0.1 * r))
    return picked & valid


def sector_bounds(start_idx: torch.Tensor, end_idx: torch.Tensor,
                  n_sectors: int = 6):
    """Sector [sp, ep] per (ring, sector). Returns (R, S) int arrays."""
    j = torch.arange(n_sectors, dtype=start_idx.dtype, device=start_idx.device)
    sp = torch.div(start_idx[:, None] * (n_sectors - j) + end_idx[:, None] * j,
                   n_sectors, rounding_mode="floor")
    ep = torch.div(
        start_idx[:, None] * (n_sectors - 1 - j) + end_idx[:, None] * (j + 1),
        n_sectors, rounding_mode="floor",
    ) - 1
    return sp, ep


def _reach_masks(col_ind: torch.Tensor):
    """(5, P) forward and backward masks: i reaches i+l (i-l) without a
    column gap > 10 on the way."""
    P = col_ind.shape[0]
    col_gap_fwd = torch.abs(torch.roll(col_ind, -1) - col_ind) > 10
    ok_f = torch.ones(P, dtype=torch.bool, device=col_ind.device)
    ok_b = torch.ones(P, dtype=torch.bool, device=col_ind.device)
    fwd, bwd = [], []
    for l in range(1, 6):
        ok_f = ok_f & (~torch.roll(col_gap_fwd, -(l - 1)))
        fwd.append(ok_f)
        ok_b = ok_b & (~torch.roll(col_gap_fwd, l))
        bwd.append(ok_b)
    return fwd, bwd


def select_edges(
    curv: torch.Tensor,  # (P,)
    col_ind: torch.Tensor,  # (P,)
    suppressed: torch.Tensor,  # (P,) occlusion mask (True = not eligible)
    valid: torch.Tensor,  # (P,)
    start_idx: torch.Tensor,  # (R,)
    end_idx: torch.Tensor,  # (R,)
    edge_threshold: float,
    max_edges_per_sector: int = 40,
    n_sectors: int = 6,
):
    """Greedy per-sector edge pick with ±5 neighbour suppression
    (`featureExtraction.cpp:150-245`), the JAX ``select_edges``: sectors in
    turn (suppression from sector j reaches into sector j+1), and in each
    `max_edges_per_sector` rounds of one masked argmax per ring, all rings
    at once. Ties go to the highest index, as the JAX function breaks them
    (the reference iterates each sector's sort from its end). Integer and
    comparison work only, so the mask is exact. Returns the (P,) bool mask
    of edge points."""
    P = curv.shape[0]
    R = start_idx.shape[0]
    dev = curv.device
    sp, ep = sector_bounds(start_idx, end_idx, n_sectors)
    idx = torch.arange(P, device=dev)
    eligible = valid & (~suppressed) & (curv > edge_threshold)
    fwd, bwd = _reach_masks(col_ind)
    neg_inf = torch.full_like(curv, -float("inf"))
    picked = torch.zeros(P, dtype=torch.bool, device=dev)
    for j in range(n_sectors):
        in_sec = (idx[None, :] >= sp[:, j, None]) & (idx[None, :] <= ep[:, j, None])
        lane_of_point = torch.argmax(in_sec.to(torch.uint8), dim=0)  # first ring
        has_lane = torch.any(in_sec, dim=0)
        lane = torch.where(has_lane, lane_of_point, torch.zeros_like(lane_of_point))
        for _ in range(max_edges_per_sector):
            score = torch.where(eligible & has_lane, curv, neg_inf)
            lane_score = torch.full((R,), -float("inf"), dtype=curv.dtype, device=dev)
            lane_score = lane_score.scatter_reduce(0, lane, torch.where(has_lane, score, neg_inf),
                                                   "amax")
            is_max = (has_lane & eligible & (score == lane_score[lane_of_point])
                      & (score > -float("inf")))
            win_idx = torch.full((R,), -1, dtype=idx.dtype, device=dev).scatter_reduce(
                0, torch.where(is_max, lane_of_point, torch.zeros_like(lane_of_point)),
                torch.where(is_max, idx, torch.full_like(idx, -1)), "amax")
            safe = torch.where(win_idx >= 0, win_idx, torch.full_like(win_idx, P))
            win = torch.zeros(P + 1, dtype=torch.bool, device=dev)
            win[safe] = True
            win = win[:P] & is_max
            picked = picked | win
            supp = win
            for l in range(1, 6):
                supp = supp | torch.roll(win & fwd[l - 1], l)
                supp = supp | torch.roll(win & bwd[l - 1], -l)
            eligible = eligible & (~supp)
    return picked


def select_edges_fast(
    curv: torch.Tensor,  # (P,)
    col_ind: torch.Tensor,  # (P,)
    suppressed: torch.Tensor,  # (P,)
    valid: torch.Tensor,  # (P,)
    start_idx: torch.Tensor,  # (R,)
    end_idx: torch.Tensor,  # (R,)
    edge_threshold: float,
    max_edges_per_sector: int = 40,
    n_sectors: int = 6,
):
    """Vectorized edge selection: a point survives iff it is the curvature
    maximum of its gap-limited ±5 window (ties to the higher index), then
    the top `max_edges_per_sector` survivors of each (ring, sector)."""
    P = curv.shape[0]
    dev = curv.device
    idx = torch.arange(P, device=dev)
    sp, ep = sector_bounds(start_idx, end_idx, n_sectors)
    eligible = valid & (~suppressed) & (curv > edge_threshold)

    neg_inf = torch.full_like(curv, -float("inf"))
    col_gap_fwd = torch.abs(torch.roll(col_ind, -1) - col_ind) > 10
    score = torch.where(eligible, curv, neg_inf)
    wmax = score
    ok_f = torch.ones(P, dtype=torch.bool, device=dev)
    ok_b = torch.ones(P, dtype=torch.bool, device=dev)
    for l in range(1, 6):
        ok_f = ok_f & (~torch.roll(col_gap_fwd, -(l - 1)))
        ok_b = ok_b & (~torch.roll(col_gap_fwd, l))
        fwd = torch.where(ok_f, torch.roll(score, -l), neg_inf)
        bwd = torch.where(ok_b, torch.roll(score, l), neg_inf)
        wmax = torch.maximum(wmax, torch.maximum(fwd, bwd))
    is_local_max = eligible & (score >= wmax)

    flat_sp = sp.reshape(-1).contiguous()
    flat_ep = ep.reshape(-1)
    lane = torch.clamp(
        torch.searchsorted(flat_sp, idx.to(flat_sp.dtype), right=True) - 1,
        0, flat_sp.shape[0] - 1,
    )
    in_lane = (idx >= flat_sp[lane]) & (idx <= flat_ep[lane])
    cand = is_local_max & in_lane
    # lexsort((-curv_cand, lane_cand)): primary lane, ties by descending
    # curvature, then index — two stable sorts
    big = torch.full_like(lane, 1 << 30)
    lane_key = torch.where(cand, lane, big)
    o1 = torch.sort(-torch.where(cand, curv, neg_inf), stable=True).indices
    o2 = torch.sort(lane_key[o1], stable=True).indices
    order = o1[o2]
    ranked_lane = lane_key[order]
    is_new = torch.ones(P, dtype=torch.bool, device=dev)
    is_new[1:] = ranked_lane[1:] != ranked_lane[:-1]
    block_start = torch.cummax(torch.where(is_new, idx, torch.zeros_like(idx)), 0).values
    rank = idx - block_start
    keep_sorted = (ranked_lane < (1 << 30)) & (rank < max_edges_per_sector)
    picked = torch.zeros(P, dtype=torch.bool, device=dev)
    picked[order] = keep_sorted  # `order` is a permutation
    return picked & cand


def surface_candidates(edge_picked: torch.Tensor, valid: torch.Tensor):
    """Surface mask = all valid compacted points that are not edges."""
    return valid & (~edge_picked)
