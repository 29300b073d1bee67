"""Visual feature tracker, the VIS front end — port of
``lvislam_tpu.models.vio.feature_tracker`` (the reference's
``FeatureTracker::readImage``, `feature_tracker.cpp:81-347`). Per frame:

1. CLAHE equalization (flag `equalize`; kernels K3 and K4 on the card),
2. pyramidal LK prev -> cur (``ops.klt``),
3. border culling,
4. F-matrix RANSAC outlier rejection on virtual-pinhole projections of the
   undistorted rays (rejectWithF, FOCAL_LENGTH=460),
5. min-dist refill to MAX_CNT by Shi-Tomasi grid detection (``ops.gftt``),
6. undistortion to the normalized plane + per-id velocity,
7. lidar depth via ``register_depth`` (DepthRegister).

The state is a fixed-capacity feature table (MAX_CNT slots, id -1 = free).
JAX's two ``lax.cond``s (RANSAC reject, refill) are computed on both sides
and selected with ``torch.where``, so a step reads nothing back to the
host. The RANSAC hypotheses come from an injectable ``sampler(weights,
n_hyp, k)``; by default a generator seeded with 0 on every frame, so the
same validity mask draws the same hypotheses, as JAX's fixed key does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn

from ...core import lie
from ...core.config import CameraIntrinsics
from ...ops import camera, depth_assoc, gftt, klt, ransac
from ...ops import image as imops


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    max_cnt: int = 150
    min_dist: int = 20
    F_threshold: float = 1.0
    equalize: bool = True
    focal_virtual: float = 460.0  # FOCAL_LENGTH for rejectWithF
    border: int = 10
    klt_levels: int = 3
    klt_half: int = 10
    klt_iters: int = 30
    # per-level sampled neighbourhood of the patch-resident LK (ops.klt);
    # margin = klt_patch/2 - klt_half - 2 px bounds trackable coarse motion
    klt_patch: int = 32
    min_track_for_F: int = 8


class TrackerState(NamedTuple):
    prev_pyr: tuple  # previous (equalized) frame's pyramid, (levels+1) images
    pts: torch.Tensor  # (N, 2) pixels
    ids: torch.Tensor  # (N,) int32, -1 = free slot
    track_cnt: torch.Tensor  # (N,) int32
    norm_pts: torch.Tensor  # (N, 2) undistorted normalized plane
    next_id: torch.Tensor  # () int32
    prev_time: torch.Tensor  # () f32
    initialized: torch.Tensor  # () bool


class TrackerOutput(NamedTuple):
    ids: torch.Tensor  # (N,)
    uv: torch.Tensor  # (N, 2)
    norm: torch.Tensor  # (N, 2)
    vel: torch.Tensor  # (N, 2) normalized-plane velocity
    valid: torch.Tensor  # (N,) features with track_cnt > 1 (the reference publishes those)
    n_tracked: torch.Tensor  # ()


Sampler = Callable[[torch.Tensor, int, int], torch.Tensor]

RANSAC_HYPOTHESES = 128


def default_sampler(weights: torch.Tensor, n_hyp: int, k: int) -> torch.Tensor:
    """A generator seeded with 0 on every call (JAX's ``PRNGKey(0)``)."""
    g = torch.Generator(device=weights.device).manual_seed(0)
    return ransac.sample_indices(weights, n_hyp, k, g)


def tracker_init(height: int, width: int, params: TrackerParams,
                 dtype=torch.float32, device=None) -> TrackerState:
    N = params.max_cnt
    shapes, h, w = [(height, width)], height, width
    for _ in range(params.klt_levels):
        h, w = (h + 1) // 2, (w + 1) // 2  # pyr_down keeps ceil(n/2)
        shapes.append((h, w))
    return TrackerState(
        prev_pyr=tuple(torch.zeros(s, dtype=dtype, device=device) for s in shapes),
        pts=torch.zeros((N, 2), dtype=dtype, device=device),
        ids=torch.full((N,), -1, dtype=torch.int32, device=device),
        track_cnt=torch.zeros(N, dtype=torch.int32, device=device),
        norm_pts=torch.zeros((N, 2), dtype=dtype, device=device),
        next_id=torch.zeros((), dtype=torch.int32, device=device),
        prev_time=torch.full((), -1.0, dtype=torch.float32, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def seed_prev_image(state: TrackerState, img: torch.Tensor,
                    params: TrackerParams) -> TrackerState:
    """Install `img` as the previous frame (equalized + pyramid), for tests
    and benches that seed a mid-stream tracker state directly."""
    if params.equalize:
        img = imops.clahe(img)
    return state._replace(
        prev_pyr=tuple(imops.build_pyramid(img, params.klt_levels)),
        initialized=torch.ones((), dtype=torch.bool, device=img.device),
    )


def tracker_step(
    state: TrackerState,
    img: torch.Tensor,  # (H, W) float in [0, 1]
    t,  # stamp: float or () tensor
    params: TrackerParams,
    cam: CameraIntrinsics,
    sampler: Sampler | None = None,
):
    """One ``readImage`` (`feature_tracker.cpp:81-207`). Returns
    (new_state, TrackerOutput)."""
    H, W = img.shape
    N = params.max_cnt
    dev = img.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    if params.equalize:
        img = imops.clahe(img)  # kernels K3 and K4 on a CUDA tensor

    occupied = state.ids >= 0

    # --- LK track forward (the prev pyramid is cached in the state) ---
    next_pyr = tuple(imops.build_pyramid(img, params.klt_levels))
    res = klt.track(
        None, img, state.pts, occupied & state.initialized,
        levels=params.klt_levels, half=params.klt_half, iters=params.klt_iters,
        patch=params.klt_patch, prev_pyr=state.prev_pyr, next_pyr=next_pyr,
    )
    pts = res.pts
    tracked = res.status & (
        (pts[:, 0] >= params.border) & (pts[:, 0] < W - params.border)
        & (pts[:, 1] >= params.border) & (pts[:, 1] < H - params.border)
    )

    # --- undistort + rejectWithF on the virtual pinhole (both sides of
    # JAX's cond, selected on the device) ---
    norm_new = camera.normalized_plane(pts, cam)
    enough = torch.sum(tracked) >= params.min_track_for_F
    center = torch.tensor([W / 2.0, H / 2.0], dtype=pts.dtype, device=dev)
    sample = sampler or default_sampler
    fr = ransac.fundamental_ransac(
        state.norm_pts * params.focal_virtual + center,
        norm_new * params.focal_virtual + center,
        tracked, threshold=params.F_threshold, n_hyp=RANSAC_HYPOTHESES,
        idx=sample(ransac.hypothesis_weights(tracked), RANSAC_HYPOTHESES, 8),
    )
    tracked = torch.where(enough, tracked & fr.inliers, tracked)

    # velocity in the normalized plane (`undistortedPoints`, `:298-347`)
    dt = torch.clamp(t - state.prev_time, min=1e-3)
    vel = torch.where((tracked & (state.track_cnt > 0))[:, None],
                      (norm_new - state.norm_pts) / dt, 0.0)
    track_cnt = torch.where(tracked, state.track_cnt + 1, 0).to(torch.int32)
    ids = torch.where(tracked, state.ids, -1).to(torch.int32)

    # --- refill: the k-th strongest detection fills the k-th free slot;
    # computed every frame (with no free slot it changes nothing, which is
    # JAX's cond) ---
    new_pts, det_ok = gftt.detect(img, pts, tracked, max_pts=N, cell=params.min_dist,
                                  border=params.border)
    free = ~tracked
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    take = free & (free_rank < torch.sum(det_ok))
    det_order = torch.argsort((~det_ok).to(torch.uint8), stable=True)
    sel_det = new_pts[det_order][torch.clamp(free_rank, 0, N - 1)]
    pts = torch.where(take[:, None], sel_det, pts)
    ids = torch.where(take, state.next_id + free_rank.to(torch.int32), ids)
    track_cnt = torch.where(take, 1, track_cnt).to(torch.int32)
    norm_new = torch.where(take[:, None], camera.normalized_plane(pts, cam), norm_new)
    vel = torch.where(take[:, None], 0.0, vel)
    next_id = state.next_id + torch.sum(take).to(torch.int32)

    new_state = TrackerState(
        prev_pyr=next_pyr,
        pts=pts,
        ids=ids,
        track_cnt=track_cnt,
        norm_pts=norm_new,
        next_id=next_id,
        prev_time=t,
        initialized=torch.ones((), dtype=torch.bool, device=dev),
    )
    out = TrackerOutput(
        ids=ids,
        uv=pts,
        norm=norm_new,
        vel=vel,
        valid=(ids >= 0) & (track_cnt > 1),
        n_tracked=torch.sum(tracked),
    )
    return new_state, out


def register_depth(
    out_norm: torch.Tensor,  # (N, 2)
    out_valid: torch.Tensor,
    cloud_world: torch.Tensor,  # (P, 3) accumulated depth cloud (world frame)
    cloud_valid: torch.Tensor,
    body_trans: torch.Tensor,  # (3,) world -> camera-body transform
    body_quat: torch.Tensor,  # (4,) [w, x, y, z]
    num_bins: int = 360,
) -> torch.Tensor:
    """DepthRegister.get_depth: transform the world cloud into the camera
    body frame, then associate (`feature_tracker.h:139-150`)."""
    ti, qi = lie.se3_inverse(body_trans, body_quat)
    local = lie.quat_rotate(qi[None], cloud_world) + ti[None]
    return depth_assoc.feature_depths(out_norm, out_valid, local, cloud_valid,
                                      num_bins=num_bins)


class FeatureTracker(nn.Module):
    """The tracker as a module: holds ``TrackerParams`` and the camera;
    ``forward(state, img, t)`` is ``tracker_step``."""

    def __init__(self, params: TrackerParams = TrackerParams(),
                 cam: CameraIntrinsics = CameraIntrinsics(),
                 sampler: Sampler | None = None):
        super().__init__()
        self.params = params
        self.cam = cam
        self.sampler = sampler

    def init_state(self, device=None) -> TrackerState:
        return tracker_init(self.cam.image_height, self.cam.image_width,
                            self.params, device=device)

    def forward(self, state: TrackerState, img: torch.Tensor, t):
        return tracker_step(state, img, t, self.params, self.cam, sampler=self.sampler)
