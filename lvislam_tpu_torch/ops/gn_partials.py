"""Kernel K2: fused LOAM coefficients + Gauss-Newton row partials of both
feature classes, in one launch per GN iteration.

Replaces the TPU kernel ``lvislam_tpu/ops/pallas_gn.py:369
gn_partials_packed`` (bodies ``_corner_kernel`` / ``_surf_kernel``), which
the JAX step calls once per class. ``gn_partials_pair`` returns the
(H (6,6), g (6,), n_res) of the corner and surf classes together: what
``scan2map.gn_update`` assembles from ``corner_coeffs_nbrs`` /
``surf_coeffs_nbrs`` rows, summed over both.

CUDA design (``csrc/gn_partials.cu``): one grid, the corner class's blocks
of 128 points then the surf class's. One thread per point follows the plain
path op for op — the world transform, the 5-neighbour 1 m² gate, the mean
and scatter, the closed-form 3×3 eigensystem with a true ``acosf`` (the TPU
kernel's polynomial acos cost +12% LIO ATE), the point-to-line or
Sherman-Morrison plane coefficients, the robust weight, the J row — then
writes its 28 partials (21 JᵀJ, 6 Jᵀb, 1 count) into shared memory, where a
fixed-order tree reduces them to one row per block. The last block to
finish (an integer ticket, reset by that block) sums each class's rows in
the order ``torch.sum(rows, dim=0)`` takes on the card, adds the classes,
and writes H, g and n_res: the same bits as a launch per class followed by
``torch.sum`` and the add, with no float atomics. Its multiply-adds are
contracted into FMAs (nvcc's default), as XLA's CPU backend contracts the
reference's: on the bench replay that moved the mean ATE over 20
rounding-perturbed runs from 0.0385 m to 0.0377 m (see PERF.md). What
bounds it on the card: latency — one thread's chain through the eigensystem
and the block sums; its 330 KB take 0.1 µs at HBM rate.

The ticket is one int32 per device, zeroed once: launches that share it
must not run concurrently (the port issues them on one stream).

``gn_partials_pair_batched`` is K2 over S sequences of equal sizes in one
launch: the form JAX's ``vmap`` of the step gives the TPU kernel, whose
batching rule adds a batch axis to its grid (``pallas_gn.py:382``,
``grid=(1,)``). The grid's y axis picks the sequence; each sequence has its
own scratch rows, ticket (an (S,) int32 buffer a device, zeroed once) and
output, and its last block sums its rows in the unbatched order, so each
sequence's (H, g, n_res) is bit-equal to its own ``gn_partials_pair``
launch. Its bound is S times the unbatched one; it stays latency-bound.

Packed layouts (the kernel reads them coalesced, one column per thread):

- ``pts`` (8, N): rows 0-2 lidar xyz, row 3 valid, rows 4-7 zero — loop
  invariant, packed once per scan;
- ``nbr`` (24, N): rows 3k+c neighbour k's coordinate c, rows 15-19 the
  present mask, rows 20-23 zero — packed on correspondence refresh;
- ``par`` (39,): R row-major (9), t (3), then Ja, Jb, Jc row-major (27),
  the per-iteration pose (see ``scan2map._euler_jac_mats``).
"""

from __future__ import annotations

import torch

from ..core.device import common
from . import _kernels

LAUNCHES = 0  # kernel launches since the last reset, whatever S (chip_smoke reads it)
_KINDS = ("corner", "surf")
_TICKETS: dict = {}  # device -> the kernel's last-block ticket (int32, zeroed once)
_BATCH_TICKETS: dict = {}  # device -> (S,) tickets of the batched launch, likewise


def pack_pts(pts_lidar: torch.Tensor, pts_valid: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points and (..., N) flags -> (..., 8, N) blocks."""
    lead, N = pts_lidar.shape[:-2], pts_lidar.shape[-2]
    return torch.cat([
        pts_lidar.transpose(-1, -2).to(torch.float32),
        pts_valid.to(torch.float32)[..., None, :],
        torch.zeros(lead + (4, N), dtype=torch.float32, device=pts_lidar.device),
    ], dim=-2).contiguous()


def pack_nbrs(nbrs: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """(..., N, 5, 3) neighbours and (..., N, 5) flags -> (..., 24, N)."""
    lead, N = nbrs.shape[:-3], nbrs.shape[-3]
    return torch.cat([
        nbrs.reshape(lead + (N, 15)).transpose(-1, -2).to(torch.float32),
        has.to(torch.float32).transpose(-1, -2),
        torch.zeros(lead + (4, N), dtype=torch.float32, device=nbrs.device),
    ], dim=-2).contiguous()


def pack_pose(Rm: torch.Tensor, t: torch.Tensor, jacs: torch.Tensor) -> torch.Tensor:
    return torch.cat([Rm.reshape(9), t.reshape(3), jacs.reshape(27)]
                     ).to(torch.float32).contiguous()


def gn_partials_plain(pts: torch.Tensor, nbr: torch.Tensor, par: torch.Tensor,
                      kind: str):
    """Plain PyTorch version: the scan2map coefficient path + the
    ``gn_update`` row assembly on the unpacked blocks."""
    from . import scan2map

    N = pts.shape[1]
    q = pts[0:3].T
    valid = pts[3] > 0.5
    nbrs = nbr[0:15].T.reshape(N, 5, 3)
    has = nbr[15:20].T > 0.5
    R = par[0:9].reshape(3, 3)
    t = par[9:12]
    jacs = par[12:39].reshape(3, 3, 3)
    pw = scan2map.apply_pose(R, t, q)
    if kind == "corner":
        co = scan2map.corner_coeffs_nbrs(pw, valid, nbrs, has)
    else:
        co = scan2map.surf_coeffs_nbrs(pw, q, valid, nbrs, has)
    J, b = scan2map.gn_rows(jacs, q, co)
    return J.T @ J, J.T @ b, torch.sum(co.valid, dtype=torch.int32)


def gn_partials_pair_plain(c_pts, c_nbr, s_pts, s_nbr, par):
    """Plain PyTorch version of ``gn_partials_pair``: one plain call per
    class, summed as ``scan2map`` sums them."""
    Hc, gc, nc = gn_partials_plain(c_pts, c_nbr, par, "corner")
    Hs, gs, ns = gn_partials_plain(s_pts, s_nbr, par, "surf")
    return Hc + Hs, gc + gs, nc + ns


def _check(pts, nbr, par):
    N = pts.shape[1]
    if pts.shape != (8, N) or nbr.shape != (24, N) or par.shape != (39,):
        raise ValueError(f"gn_partials: bad shapes {tuple(pts.shape)} "
                         f"{tuple(nbr.shape)} {tuple(par.shape)}")
    for t in (pts, nbr, par):
        if t.dtype != torch.float32:
            raise TypeError("gn_partials: expects float32 blocks")
    return pts.contiguous(), nbr.contiguous(), N


def _launch(c_blocks, s_blocks, par):
    """One K2 launch; a class given as None is empty."""
    global LAUNCHES
    par = par.contiguous()
    cls = [_check(*b, par) if b is not None else (None, None, 0)
           for b in (c_blocks, s_blocks)]
    n_blocks = sum((N + 127) // 128 for _, _, N in cls)
    out = torch.empty(43, dtype=torch.float32, device=par.device)
    if not n_blocks:
        out.zero_()
    else:
        dev = par.device
        if dev not in _TICKETS:
            _TICKETS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
        rows = torch.empty((n_blocks, 28), dtype=torch.float32, device=dev)
        ptrs = []
        for pts, nbr, N in cls:
            ptrs += [pts.data_ptr() if N else None, nbr.data_ptr() if N else None, N]
        lib = _kernels.library()
        with torch.cuda.device(dev):  # launch on the inputs' card
            stream = torch.cuda.current_stream(dev).cuda_stream
            _kernels.check(lib.lvt_gn_partials_pair(*ptrs, par.data_ptr(), rows.data_ptr(),
                                                    _TICKETS[dev].data_ptr(), out.data_ptr(),
                                                    stream), "lvt_gn_partials_pair")
        LAUNCHES += 1
    # out: H row-major (36), g (6), then n_res's int32 bits
    return out[:36].view(6, 6), out[36:42], out[42:].view(torch.int32)[0]


def gn_partials_pair(c_pts: torch.Tensor, c_nbr: torch.Tensor, s_pts: torch.Tensor,
                     s_nbr: torch.Tensor, par: torch.Tensor):
    """(H (6,6), g (6,), n_res () int32) of the corner class (``c_*``) and
    the surf class (``s_*``) together, from packed blocks. Tensors all on
    the CPU take the plain version; tensors all on the card launch kernel K2
    once; any mix raises."""
    dev = common((c_pts, c_nbr, s_pts, s_nbr, par), "gn_partials")
    if dev.type == "cpu":
        return gn_partials_pair_plain(c_pts, c_nbr, s_pts, s_nbr, par)
    if dev.type != "cuda":
        raise ValueError(f"gn_partials: unsupported device {dev}")
    return _launch((c_pts, c_nbr), (s_pts, s_nbr), par)


def gn_partials(pts: torch.Tensor, nbr: torch.Tensor, par: torch.Tensor,
                kind: str):
    """(H (6,6), g (6,), n_res () int32) for one feature class ("corner" or
    "surf") from packed blocks. A CPU tensor takes the plain version; a
    CUDA tensor launches kernel K2 with the other class empty."""
    if kind not in _KINDS:
        raise ValueError(f"gn_partials: unknown kind {kind!r}")
    dev = common((pts, nbr, par), "gn_partials")
    if dev.type == "cpu":
        return gn_partials_plain(pts, nbr, par, kind)
    if dev.type != "cuda":
        raise ValueError(f"gn_partials: unsupported device {dev}")
    blocks = (pts, nbr)
    return _launch(blocks if kind == "corner" else None,
                   blocks if kind == "surf" else None, par)


def gn_partials_pair_batched_plain(c_pts, c_nbr, s_pts, s_nbr, par):
    """Plain PyTorch version of ``gn_partials_pair_batched``:
    ``gn_partials_pair_plain`` a sequence, stacked."""
    outs = [gn_partials_pair_plain(c_pts[i], c_nbr[i], s_pts[i], s_nbr[i], par[i])
            for i in range(par.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def _check_batched(c_pts, c_nbr, s_pts, s_nbr, par):
    S, Nc, Ns = par.shape[0], c_pts.shape[-1], s_pts.shape[-1]
    if (par.shape != (S, 39) or S < 1 or c_pts.shape != (S, 8, Nc)
            or c_nbr.shape != (S, 24, Nc) or s_pts.shape != (S, 8, Ns)
            or s_nbr.shape != (S, 24, Ns)):
        raise ValueError("gn_partials_batched: bad shapes "
                         + " ".join(str(tuple(t.shape)) for t in (c_pts, c_nbr, s_pts,
                                                                  s_nbr, par)))
    for t in (c_pts, c_nbr, s_pts, s_nbr, par):
        if t.dtype != torch.float32:
            raise TypeError("gn_partials_batched: expects float32 blocks")


def _launch_batched(c_pts, c_nbr, s_pts, s_nbr, par):
    global LAUNCHES
    S, Nc, Ns = par.shape[0], c_pts.shape[-1], s_pts.shape[-1]
    dev = par.device
    out = torch.empty((S, 43), dtype=torch.float32, device=dev)
    n_blocks = (Nc + 127) // 128 + (Ns + 127) // 128
    if not n_blocks:
        out.zero_()
    else:
        blocks = [t.contiguous() for t in (c_pts, c_nbr, s_pts, s_nbr, par)]
        if dev not in _BATCH_TICKETS or _BATCH_TICKETS[dev].numel() < S:
            _BATCH_TICKETS[dev] = torch.zeros(S, dtype=torch.int32, device=dev)
        rows = torch.empty((S, n_blocks, 28), dtype=torch.float32, device=dev)
        c_p, c_n, s_p, s_n, par = (t.data_ptr() for t in blocks)
        lib = _kernels.library()
        with torch.cuda.device(dev):  # launch on the inputs' card
            stream = torch.cuda.current_stream(dev).cuda_stream
            _kernels.check(lib.lvt_gn_partials_pair_batched(
                c_p if Nc else None, c_n if Nc else None, Nc, s_p if Ns else None,
                s_n if Ns else None, Ns, S, par, rows.data_ptr(),
                _BATCH_TICKETS[dev].data_ptr(), out.data_ptr(), stream),
                "lvt_gn_partials_pair_batched")
        LAUNCHES += 1
    # a row a sequence: H row-major (36), g (6), then n_res's int32 bits
    return (out[:, :36].unflatten(1, (6, 6)), out[:, 36:42],
            out[:, 42:].view(torch.int32)[:, 0])


def gn_partials_pair_batched(c_pts: torch.Tensor, c_nbr: torch.Tensor,
                             s_pts: torch.Tensor, s_nbr: torch.Tensor, par: torch.Tensor):
    """``gn_partials_pair`` of S sequences at once: blocks (S, 8, Nc),
    (S, 24, Nc), (S, 8, Ns), (S, 24, Ns) and poses (S, 39) give H (S, 6, 6),
    g (S, 6) and n_res (S,) int32, each sequence's bit-equal to its own
    ``gn_partials_pair``. Tensors all on the CPU take the plain version;
    tensors all on the card launch kernel K2 once for all S; any mix
    raises."""
    dev = common((c_pts, c_nbr, s_pts, s_nbr, par), "gn_partials_batched")
    _check_batched(c_pts, c_nbr, s_pts, s_nbr, par)
    if dev.type == "cpu":
        return gn_partials_pair_batched_plain(c_pts, c_nbr, s_pts, s_nbr, par)
    if dev.type != "cuda":
        raise ValueError(f"gn_partials_batched: unsupported device {dev}")
    return _launch_batched(c_pts, c_nbr, s_pts, s_nbr, par)
