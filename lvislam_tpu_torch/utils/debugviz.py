"""Debug-image observability — port of ``lvislam_tpu.utils.debugviz``, the
counterpart of the reference's visual debug topics: the tracker's annotated
feature image (`feature_tracker_node.cpp` pub_match / `visualization.cpp`),
the pose graph's loop `match_image` (`pose_graph/src/keyframe.cpp:
setMatchImage`), the depth-registration overlay (`depth_image` in
`feature_tracker_node.cpp`), the top-down global map and the standalone
HTML viewer.

Host code, as in the JAX package: numpy rasterization written as binary
PPM/PGM (no image library), byte for byte the JAX module's output on the
same arrays. `LviSystem(debug_dir=...)` drops one artifact per stage at a
configurable stride; callers pass host arrays (a tensor is read back first).
"""

from __future__ import annotations

import os

import numpy as np


def save_ppm(path: str, img: np.ndarray) -> None:
    """Write (H, W) grayscale as PGM or (H, W, 3) RGB as PPM (binary)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 if img.max() <= 1.5 else img, 0, 255)
        img = img.astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        if img.ndim == 2:
            f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        else:
            f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def _to_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    rgb = np.repeat(np.clip(img, 0, 1)[..., None], 3, axis=-1)
    return rgb


def _draw_cross(rgb, x, y, color, r=2):
    H, W, _ = rgb.shape
    x, y = int(round(x)), int(round(y))
    if not (0 <= x < W and 0 <= y < H):
        return
    rgb[max(y - r, 0):min(y + r + 1, H), x] = color
    rgb[y, max(x - r, 0):min(x + r + 1, W)] = color


def _draw_line(rgb, x0, y0, x1, y1, color):
    H, W, _ = rgb.shape
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n + 1).round().astype(int)
    ys = np.linspace(y0, y1, n + 1).round().astype(int)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    rgb[ys[ok], xs[ok]] = color


def draw_tracks(img, uv, valid, track_cnt=None, uv_prev=None) -> np.ndarray:
    """The reference's feature image: tracked features as crosses colored
    by track maturity (red=new .. blue=long-tracked, as in
    `feature_tracker_node.cpp` pub_match coloring), with optional velocity
    tails."""
    rgb = _to_rgb(img)
    uv = np.asarray(uv)
    valid = np.asarray(valid)
    cnt = np.asarray(track_cnt) if track_cnt is not None else np.full(len(uv), 10)
    for i in np.nonzero(valid)[0]:
        m = min(float(cnt[i]) / 20.0, 1.0)
        color = np.array([1.0 - m, 0.0, m], np.float32)
        if uv_prev is not None:
            _draw_line(rgb, uv_prev[i, 0], uv_prev[i, 1],
                       uv[i, 0], uv[i, 1], np.array([0.0, 1.0, 0.0]))
        _draw_cross(rgb, uv[i, 0], uv[i, 1], color)
    return rgb


def draw_matches(img_old, img_new, uv_old, uv_new, ok) -> np.ndarray:
    """The pose graph's loop `match_image`: old|new side by side with
    match lines (`keyframe.cpp` drawMatches equivalent)."""
    a, b = _to_rgb(img_old), _to_rgb(img_new)
    H = max(a.shape[0], b.shape[0])
    Wa = a.shape[1]
    canvas = np.zeros((H, Wa + b.shape[1], 3), np.float32)
    canvas[: a.shape[0], :Wa] = a
    canvas[: b.shape[0], Wa:] = b
    uv_old = np.asarray(uv_old)
    uv_new = np.asarray(uv_new)
    for i in np.nonzero(np.asarray(ok))[0]:
        _draw_cross(canvas, uv_old[i, 0], uv_old[i, 1], np.array([1.0, 1.0, 0.0]))
        _draw_cross(canvas, uv_new[i, 0] + Wa, uv_new[i, 1], np.array([0.0, 1.0, 1.0]))
        _draw_line(canvas, uv_old[i, 0], uv_old[i, 1],
                   uv_new[i, 0] + Wa, uv_new[i, 1], np.array([0.0, 0.8, 0.0]))
    return canvas


def draw_depth_overlay(img, uv, depth, valid, d_max=20.0) -> np.ndarray:
    """The depth-registration overlay (`feature_tracker_node.cpp`
    depth_image): features colored by associated lidar depth (near=red,
    far=blue); depth<=0 drawn gray."""
    rgb = _to_rgb(img)
    uv = np.asarray(uv)
    depth = np.asarray(depth)
    for i in np.nonzero(np.asarray(valid))[0]:
        if depth[i] > 0:
            m = min(float(depth[i]) / d_max, 1.0)
            color = np.array([1.0 - m, 0.1, m], np.float32)
        else:
            color = np.array([0.5, 0.5, 0.5], np.float32)
        _draw_cross(rgb, uv[i, 0], uv[i, 1], color, r=3)
    return rgb


def draw_map_topdown(
    map_xyz: np.ndarray,
    map_valid: np.ndarray | None = None,
    trajectory: np.ndarray | None = None,
    size: int = 800,
    margin: float = 1.0,
) -> np.ndarray:
    """Top-down global-map render — the counterpart of the reference's
    RViz global-map cloud + path topics (`visualizeGlobalMapThread` /
    `publishGlobalMap`, `mapOptimization.cpp:421-510`, and the trajectory
    path of `publishFrames`). Points shaded by height (low=dark blue,
    high=yellow-green); trajectory drawn red over the cloud.

    map_xyz: (N, 3) world-frame points; trajectory: (T, 3) positions.
    Returns (size, size, 3) float RGB for `save_ppm`.
    """
    pts = np.asarray(map_xyz, np.float32).reshape(-1, 3)
    if map_valid is not None:
        pts = pts[np.asarray(map_valid).reshape(-1)]
    pts = pts[np.isfinite(pts).all(-1)]
    tr = None
    if trajectory is not None:
        tr = np.asarray(trajectory, np.float32).reshape(-1, 3)
    allp = pts if tr is None or not len(tr) else np.concatenate([pts, tr])
    canvas = np.zeros((size, size, 3), np.float32)
    if not len(allp):
        return canvas
    lo = allp[:, :2].min(0) - margin
    hi = allp[:, :2].max(0) + margin
    scale = (size - 1) / max(float((hi - lo).max()), 1e-6)

    def to_px(xy):
        p = ((xy - lo) * scale).round().astype(int)
        return np.clip(p[:, 0], 0, size - 1), np.clip(
            size - 1 - p[:, 1], 0, size - 1)

    if len(pts):
        z = pts[:, 2]
        z0, z1 = np.percentile(z, [5, 95])
        m = np.clip((z - z0) / max(z1 - z0, 1e-6), 0, 1)[:, None]
        col = (1 - m) * np.array([[0.15, 0.25, 0.55]]) + m * np.array(
            [[0.65, 0.85, 0.25]])
        xs, ys = to_px(pts[:, :2])
        canvas[ys, xs] = np.maximum(canvas[ys, xs], col.astype(np.float32))
    if tr is not None and len(tr) > 1:
        xs, ys = to_px(tr[:, :2])
        red = np.array([1.0, 0.15, 0.15], np.float32)
        for i in range(len(xs) - 1):
            _draw_line(canvas, xs[i], ys[i], xs[i + 1], ys[i + 1], red)
    return canvas


# ---------------------------------------------------------- HTML 3D viewer

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>lvislam_tpu viewer</title>
<style>
 body{margin:0;background:#10141a;color:#cfd8e3;font:12px sans-serif;
      overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;opacity:.85;pointer-events:none}
 canvas{display:block}
</style></head><body>
<div id="hud">lvislam_tpu replay &mdash; drag: orbit &middot; shift-drag:
 pan &middot; wheel: zoom<br><span id="stats"></span></div>
<canvas id="cv"></canvas>
<script>
const DATA = __DATA_JSON__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let W, H; const resize = () => { W = cv.width = innerWidth;
  H = cv.height = innerHeight; }; resize(); onresize = () => {resize();draw();};
// center the scene
const all = [];
for (const k of ['map','traj','gt']) if (DATA[k]) all.push(...DATA[k]);
let cx=0, cy=0, cz=0, R=1;
if (all.length){
  for (const p of all){cx+=p[0];cy+=p[1];cz+=p[2];}
  cx/=all.length; cy/=all.length; cz/=all.length;
  for (const p of all) R = Math.max(R, Math.hypot(p[0]-cx,p[1]-cy,p[2]-cz));
}
let yaw=-0.7, pitch=0.5, dist=2.6*R, panx=0, pany=0;
function project(p){
  const x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  const cyw=Math.cos(yaw), syw=Math.sin(yaw);
  const cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x1=cyw*x+syw*y, y1=-syw*x+cyw*y;        // yaw about +z
  const y2=cp*y1-sp*z,  z2=sp*y1+cp*z;           // pitch
  const d=y2+dist; if (d<=0.01) return null;
  const f=0.9*Math.min(W,H)/ (d/R);
  return [W/2+f*(x1/R)+panx, H/2-f*(z2/R)+pany, d];
}
function zcol(z){
  const t=Math.max(0,Math.min(1,(z-DATA.z0)/(DATA.z1-DATA.z0||1)));
  const r=38+t*128, g=64+t*153, b=140-t*76;
  return `rgb(${r|0},${g|0},${b|0})`;
}
function polyline(pts, style, w){
  ctx.strokeStyle=style; ctx.lineWidth=w; ctx.beginPath(); let started=false;
  for (const p of pts){const q=project(p); if(!q){started=false;continue;}
    if(!started){ctx.moveTo(q[0],q[1]);started=true;} else ctx.lineTo(q[0],q[1]);}
  ctx.stroke();
}
function draw(){
  ctx.fillStyle='#10141a'; ctx.fillRect(0,0,W,H);
  if (DATA.map) for (const p of DATA.map){
    const q=project(p); if(!q) continue;
    ctx.fillStyle=zcol(p[2]);
    const s=Math.max(1, 3.0*R/q[2]);
    ctx.fillRect(q[0],q[1],s,s);
  }
  if (DATA.gt)  polyline(DATA.gt,  '#5a9e6f', 1.5);
  if (DATA.traj) polyline(DATA.traj,'#e05252', 2);
  if (DATA.loops) for (const e of DATA.loops){
    polyline([DATA.traj[e[0]], DATA.traj[e[1]]], '#e0c040', 1);
  }
  document.getElementById('stats').textContent =
    `${(DATA.map||[]).length} map pts, ${(DATA.traj||[]).length} poses` +
    (DATA.gt?`, GT overlay`:``) +
    (DATA.loops&&DATA.loops.length?`, ${DATA.loops.length} loop edges`:``);
}
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];};
onmouseup=()=>{drag=null;};
onmousemove=e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if (drag[2]){panx+=dx; pany+=dy;}
  else {yaw+=dx*0.008; pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
  drag=[e.clientX,e.clientY,drag[2]]; draw();
};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); draw(); e.preventDefault();};
draw();
</script></body></html>
"""


def export_html_viewer(
    path: str,
    trajectory: np.ndarray,
    map_xyz: np.ndarray | None = None,
    map_valid: np.ndarray | None = None,
    gt: np.ndarray | None = None,
    loop_pairs: np.ndarray | None = None,
    max_points: int = 120_000,
) -> str:
    """Standalone interactive 3D HTML viewer (orbit / pan / zoom) — the
    replay-framework counterpart of the reference's live RViz session
    (global map cloud + path + loop-edge markers,
    `mapOptimization.cpp:421-510 publishGlobalMap`, `visualization.cpp`
    pubPath/pubKeyframes, loop `MarkerArray` in
    `mapOptimization.cpp:665-741`). Zero dependencies on either side:
    embeds the decimated cloud + trajectories as JSON in one HTML file
    rendered with a hand-rolled canvas projector.

    trajectory/gt: (T, 3) positions; map_xyz: (N, 3) world points;
    loop_pairs: (L, 2) int indices into `trajectory`. Returns `path`.
    """
    import json

    tr = np.asarray(trajectory, np.float32).reshape(-1, 3)
    data: dict = {"traj": tr.round(3).tolist()}
    z0, z1 = 0.0, 1.0
    if map_xyz is not None:
        pts = np.asarray(map_xyz, np.float32).reshape(-1, 3)
        if map_valid is not None:
            pts = pts[np.asarray(map_valid).reshape(-1)]
        pts = pts[np.isfinite(pts).all(-1)]
        if len(pts) > max_points:  # uniform decimation, keep shape
            pts = pts[:: int(np.ceil(len(pts) / max_points))]
        if len(pts):
            z0, z1 = (float(x) for x in np.percentile(pts[:, 2], [5, 95]))
        data["map"] = pts.round(3).tolist()
    if gt is not None:
        data["gt"] = np.asarray(gt, np.float32).reshape(-1, 3).round(
            3).tolist()
    if loop_pairs is not None and len(loop_pairs):
        data["loops"] = np.asarray(loop_pairs, np.int64).reshape(
            -1, 2).tolist()
    data["z0"], data["z1"] = z0, z1
    html = _HTML_TEMPLATE.replace("__DATA_JSON__", json.dumps(data))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
