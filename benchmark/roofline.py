"""The work of kernels K1-K4 counted from the algorithm's shapes, and the
card's published peaks.

Each function gives (bytes, float32 operations) of one launch on the main
path: every input byte read once and every output byte written once,
whatever the kernel reads again, and the operations the algorithm needs,
counted as the port's kernel tables count them (``PERF.md``: K1 11.8 MB,
K2 0.33 MB, K3 2.4 MB, K4 4.8 MB at the main path's shapes). A kernel's
roofline share is the least time these allow, the larger of bytes over the
memory rate and operations over the float32 rate, over the device time the
trace gives its launches.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: HBM3 3.35 TB/s,
# 67 TFLOP/s float32 outside the tensor cores
PEAK = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12, "power_limit_w": 700.0}

K_NEIGHBOURS = 5  # K1 keeps the 5 nearest of the 27 cells around a query
CELLS = 27
# K2's float32 operations a point (transform, gate, mean, scatter, 3x3
# eigensystem, line or plane coefficients, Jacobian row, 27 partials, the
# block tree), counted by hand from the algorithm
K2_FLOPS_PER_POINT = {"corner": 450, "surf": 600}
K2_POSE_FLOATS, K2_OUT_FLOATS = 39, 43  # R, t, 27 Euler Jacobians in; H, g, n out
CLAHE_TILES, CLAHE_BINS = 8, 256  # an 8 x 8 grid of 256-bin tile histograms


def k1_query_set(Q: int, B: int) -> tuple[int, int]:
    """One query set of K1: Q queries, each scoring the B slots of its 27
    voxel cells. In: the cells' int16 planar rows (Q, 27, 4, B), the wanted
    int32 tags (Q, 27), the float32 cell-corner offsets (Q, 81); out: the k
    nearest float32 distances and int32 positions (Q, k). A candidate costs
    3 offset adds, 3 squares and 2 adds."""
    n_bytes = Q * CELLS * 4 * B * 2 + Q * CELLS * 4 + Q * CELLS * 3 * 4 + Q * K_NEIGHBOURS * 8
    return n_bytes, Q * CELLS * B * 8


def k1_pair(sets) -> tuple[int, int]:
    """K1's one launch for both feature classes: `sets` = [(Q, B), ...]."""
    parts = [k1_query_set(Q, B) for Q, B in sets]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def k2_pair(n_corner: int, n_surf: int) -> tuple[int, int]:
    """K2's one launch a GN iteration: per point 8 packed floats of the
    point and 24 of its 5 neighbours in, the pose block in, the 43-float
    (H, g, n) sum out."""
    n_bytes = (n_corner + n_surf) * 32 * 4 + (K2_POSE_FLOATS + K2_OUT_FLOATS) * 4
    flops = n_corner * K2_FLOPS_PER_POINT["corner"] + n_surf * K2_FLOPS_PER_POINT["surf"]
    return n_bytes, flops


def k3_hist(H: int, W: int) -> tuple[int, int]:
    """K3: a float32 image in, 64 x 256 float32 counts out; a pixel costs a
    scale, a clamp and a count."""
    return H * W * 4 + CLAHE_TILES ** 2 * CLAHE_BINS * 4, 3 * H * W


def k4_apply(H: int, W: int) -> tuple[int, int]:
    """K4: the image and the 64 tile CDFs in, the equalized image out; a
    pixel blends 4 CDF lookups bilinearly (12 operations)."""
    return 2 * H * W * 4 + CLAHE_TILES ** 2 * CLAHE_BINS * 4, 12 * H * W


def bound_us(n_bytes: float, n_flops: float) -> float:
    """The least µs a launch can take at the published peaks."""
    return max(n_bytes / PEAK["hbm_bytes_per_s"], n_flops / PEAK["f32_flops_per_s"]) * 1e6


def launch_work(kernel: str, program: dict) -> tuple[int, int]:
    """(bytes, operations) of one main-path launch of `kernel` ("K1".."K4")
    under a configuration's program fields (a LIO configuration, or a fused
    one whose LIO block is ``program["lio"]``)."""
    lio = program.get("lio", program)
    caps = lio["caps"]
    if kernel == "K1":
        return k1_pair([(caps["scan_corner"], caps["hash_bucket"]),
                        (caps["scan_surf"], caps["surf_hash_bucket"])])
    if kernel == "K2":
        return k2_pair(caps["scan_corner"], caps["scan_surf"])
    cam = program["camera"]
    fn = k3_hist if kernel == "K3" else k4_apply
    return fn(cam["image_height"], cam["image_width"])


def share_pct(kernel: str, program: dict, durations_us) -> float | None:
    """A kernel's roofline share in %: its launches' least time over their
    traced device time; None where the trace holds no launch of it."""
    durations_us = list(durations_us)
    total = sum(durations_us)
    if not durations_us or total <= 0:
        return None
    return 100.0 * len(durations_us) * bound_us(*launch_work(kernel, program)) / total
