"""Checkpoint / resume + map export — port of ``lvislam_tpu.utils.checkpoint``.

The reference's only persistence is the `lio_sam/save_map` service writing
trajectory + corner/surf/global PCDs (`mapOptimization.cpp:179-238`) and
the dead pose-graph save/load (`pose_graph.cpp:697,752`). Here an
estimator state is one tree of NamedTuples of tensors, so checkpointing is
total:

- `save_state` / `load_state`: the tree as one flat dict of tensors by
  dotted field path, written by ``torch.save`` and read back by
  ``torch.load(weights_only=True)`` into the structure of a template
  (shape-checked), onto a given device;
- `save_map_service`: the LIS keyframe map -> ASCII PCD files + TUM-format
  trajectory, with optional voxel resolution, and the offline viewer
  artifacts (the top-down PPM and the HTML viewer of `utils/debugviz.py`):
  the same files and bytes as the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.device import resolve as resolve_device


def _flatten(tree, prefix: str = "") -> dict:
    """{dotted path: tensor} of a NamedTuple tree (tuples of tensors by
    index)."""
    out = {}
    for name in tree._fields:
        v = getattr(tree, name)
        key = prefix + name
        if hasattr(v, "_fields"):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, tuple):
            out.update({f"{key}.{i}": x for i, x in enumerate(v)})
        else:
            out[key] = v
    return out


def _rebuild(template, flat: dict, device, prefix: str = ""):
    fields = {}
    for name in template._fields:
        v = getattr(template, name)
        key = prefix + name
        if hasattr(v, "_fields"):
            fields[name] = _rebuild(v, flat, device, key + ".")
        elif isinstance(v, tuple):
            fields[name] = tuple(_leaf(f"{key}.{i}", x, flat, device) for i, x in enumerate(v))
        else:
            fields[name] = _leaf(key, v, flat, device)
    return type(template)(**fields)


def _leaf(key, like, flat, device):
    if key not in flat:
        raise ValueError(f"{key}: missing from the checkpoint")
    t = flat[key]
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(like.shape)}")
    return t.to(device)


def save_state(path: str, state) -> None:
    """Write a NamedTuple tree of tensors (`LioMapState`, `VioState`, ...)
    as a flat dict of CPU tensors (``torch.save``)."""
    torch.save({k: v.detach().cpu() for k, v in _flatten(state).items()}, path)


def load_state(path: str, template, device=None):
    """Load into the structure of `template` (shape-checked) on `device`
    (the card unless named; ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    flat = torch.load(path, map_location="cpu", weights_only=True)
    return _rebuild(template, flat, dev)


def write_pcd(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None):
    """Minimal ASCII PCD writer (pcl::io::savePCDFileASCII equivalent)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = "x y z" + (" intensity" if intensity is not None else "")
    sizes = "4 4 4" + (" 4" if intensity is not None else "")
    types = "F F F" + (" F" if intensity is not None else "")
    counts = "1 1 1" + (" 1" if intensity is not None else "")
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            f"VERSION 0.7\nFIELDS {fields}\nSIZE {sizes}\nTYPE {types}\n"
            f"COUNT {counts}\nWIDTH {n}\nHEIGHT 1\n"
            "VIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA ascii\n"
        )
        for i in range(n):
            row = f"{xyz[i,0]:.6f} {xyz[i,1]:.6f} {xyz[i,2]:.6f}"
            if intensity is not None:
                row += f" {float(intensity[i]):.6f}"
            f.write(row + "\n")


def save_trajectory_tum(path: str, stamps, trans, quats_wxyz):
    """TUM format: `t x y z qx qy qz qw` (consumed by evo etc.)."""
    with open(path, "w") as f:
        for t, p, q in zip(stamps, trans, quats_wxyz):
            f.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )


def global_map_points(state, resolution: float = 0.0):
    """World-frame (corner, surf) global clouds assembled from the
    keyframe database — the `publishGlobalMap` cloud
    (`mapOptimization.cpp:421-510`), optionally re-downsampled at
    `resolution` (the saveMapService arg); numpy, on the host."""
    from ..core import lie
    from ..ops import pointcloud as pc

    n = int(state.kf_count)
    kt = state.kf_trans[:n]
    kq = state.kf_quat[:n]

    def assemble(clouds, valids):
        pts = []
        for k in range(n):
            p = clouds[k][valids[k]]
            pts.append((lie.quat_rotate(kq[k][None], p) + kt[k][None]).cpu().numpy())
        if not pts:
            return np.zeros((0, 3), np.float32)
        out = np.concatenate(pts)
        if resolution > 0 and len(out):
            xyz, valid, _ = pc.voxel_downsample(
                torch.from_numpy(out).to(kt.device),
                torch.ones(len(out), dtype=torch.bool, device=kt.device), resolution,
                capacity=max(1024, 1 << int(np.ceil(np.log2(len(out))))),
            )
            out = xyz[valid].cpu().numpy()
        return out

    return (assemble(state.kf_corner, state.kf_corner_valid),
            assemble(state.kf_surf, state.kf_surf_valid))


def save_map_service(state, out_dir: str, resolution: float = 0.0):
    """`saveMapService` (`mapOptimization.cpp:179-238`): writes
    trajectory.pcd (keyframe positions), transformations (TUM), corner/surf
    global maps (optionally re-downsampled at `resolution`), their union
    (GlobalMap.pcd), plus the offline visualization artifacts (top-down PPM
    + interactive HTML)."""
    os.makedirs(out_dir, exist_ok=True)
    n = int(state.kf_count)
    kt = state.kf_trans[:n].cpu().numpy()
    kq = state.kf_quat[:n].cpu().numpy()
    ktime = state.kf_time[:n].cpu().numpy()
    write_pcd(os.path.join(out_dir, "trajectory.pcd"), kt)
    save_trajectory_tum(os.path.join(out_dir, "transformations.txt"), ktime, kt, kq)

    corner, surf = global_map_points(state, resolution)
    write_pcd(os.path.join(out_dir, "CornerMap.pcd"), corner)
    write_pcd(os.path.join(out_dir, "SurfMap.pcd"), surf)
    if len(corner) + len(surf):
        gmap = np.concatenate([corner, surf]) if len(corner) else surf
        write_pcd(os.path.join(out_dir, "GlobalMap.pcd"), gmap)
        # top-down render — the RViz global-map + path view
        # (`visualizeGlobalMapThread`, `mapOptimization.cpp:421-510`)
        from .debugviz import draw_map_topdown, export_html_viewer, save_ppm

        save_ppm(os.path.join(out_dir, "GlobalMap_topdown.ppm"),
                 draw_map_topdown(gmap, trajectory=kt))
        # interactive 3D session — the live-RViz counterpart
        export_html_viewer(os.path.join(out_dir, "viewer.html"), kt, map_xyz=gmap)
    return dict(n_keyframes=n, n_corner=len(corner), n_surf=len(surf))
