"""Interactive 3-D scene export: one self-contained HTML file per frame
(counterpart of ``hgsfusion_tpu/utils/visual_3d.py``, the same file for the
same inputs).

The reference demo opens an open3d window over the point cloud and the box
wireframes. A headless serving host has no GL, so the scene goes into one
.html file instead: the points and box corners inlined as JSON and a
dependency-free canvas renderer (perspective projection, orbit camera) in
plain JavaScript: drag to orbit, wheel to zoom, shift-drag to pan, 'g' / 'p'
to toggle the gt / predicted boxes. It opens in any browser.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 html,body{margin:0;height:100%;background:#101014;overflow:hidden}
 canvas{display:block;width:100vw;height:100vh;cursor:grab}
 #hud{position:fixed;top:8px;left:10px;color:#9aa;font:12px monospace;
      user-select:none;pointer-events:none;white-space:pre}
</style></head><body>
<div id="hud"></div><canvas id="cv"></canvas>
<script id="scene" type="application/json">__DATA__</script>
<script>
"use strict";
const S = JSON.parse(document.getElementById("scene").textContent);
const cv = document.getElementById("cv"), g = cv.getContext("2d");
const hud = document.getElementById("hud");
// scene center/extent from the point cloud (fallback: pc_range)
const P = S.points;                      // [[x,y,z,c01], ...]
let cx=0, cy=0, cz=0;
for (const p of P) { cx+=p[0]; cy+=p[1]; cz+=p[2]; }
if (P.length) { cx/=P.length; cy/=P.length; cz/=P.length; }
let yaw = -2.4, pitch = 0.5, dist = S.extent * 1.6, panx = 0, pany = 0;
let showGt = true, showPred = true;
const EDGES = [[0,1],[1,2],[2,3],[3,0],[4,5],[5,6],[6,7],[7,4],
               [0,4],[1,5],[2,6],[3,7]];
function proj(x, y, z, M, out) {
  // world -> camera (orbit around scene center) -> perspective
  x-=cx; y-=cy; z-=cz;
  const X = M[0]*x+M[1]*y+M[2]*z + panx,
        Y = M[3]*x+M[4]*y+M[5]*z + pany,
        Z = M[6]*x+M[7]*y+M[8]*z + dist;
  if (Z < 0.2) return false;
  const f = 0.9 * Math.min(cv.width, cv.height) / Z;
  out[0] = cv.width/2 + X*f; out[1] = cv.height/2 - Y*f; out[2] = Z;
  return true;
}
function rotm() {
  const cy_=Math.cos(yaw), sy=Math.sin(yaw),
        cp=Math.cos(pitch), sp=Math.sin(pitch);
  // R = Rx(pitch) @ Rz(yaw): lidar +z up, orbit in the xy ground plane
  return [cy_,sy,0, -sy*cp,cy_*cp,sp, sy*sp,-cy_*sp,cp];
}
function colormap(t) { // height/intensity ramp: blue -> cyan -> yellow
  const h = 240 - 180*Math.max(0, Math.min(1, t));
  return `hsl(${h},85%,60%)`;
}
function drawBoxes(M, boxes, color, scores) {
  g.strokeStyle = color; g.fillStyle = color; g.lineWidth = 1.2;
  const q = new Array(3);
  for (let i = 0; i < boxes.length; i++) {
    const c = boxes[i], uv = [];
    let ok = true;
    for (let k = 0; k < 8; k++) {
      if (!proj(c[k][0], c[k][1], c[k][2], M, q)) { ok = false; break; }
      uv.push([q[0], q[1]]);
    }
    if (!ok) continue;
    g.beginPath();
    for (const [a, b] of EDGES) {
      g.moveTo(uv[a][0], uv[a][1]); g.lineTo(uv[b][0], uv[b][1]);
    }
    g.stroke();
    if (scores) g.fillText(scores[i].toFixed(2), uv[0][0]+3, uv[0][1]-3);
  }
}
function draw() {
  cv.width = innerWidth; cv.height = innerHeight;
  g.fillStyle = "#101014"; g.fillRect(0, 0, cv.width, cv.height);
  const M = rotm(), q = new Array(3);
  const s = 1.6;
  for (const p of P) {
    if (!proj(p[0], p[1], p[2], M, q)) continue;
    g.fillStyle = colormap(p[3]);
    g.fillRect(q[0]-s/2, q[1]-s/2, s, s);
  }
  g.font = "11px monospace";
  if (showGt && S.gt_boxes.length) drawBoxes(M, S.gt_boxes, "#22d3ee");
  if (showPred && S.pred_boxes.length)
    drawBoxes(M, S.pred_boxes, "#4ade80", S.pred_scores);
  hud.textContent =
    `${S.title}\\n${P.length} pts  gt[g]:${showGt?S.gt_boxes.length:"off"}` +
    `  pred[p]:${showPred?S.pred_boxes.length:"off"}` +
    `\\ndrag orbit · wheel zoom · shift-drag pan`;
}
let drag = null;
cv.addEventListener("mousedown", e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2};
});
addEventListener("mouseup", () => drag = null);
addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (drag.pan) {
    const k = dist / Math.min(cv.width, cv.height);
    panx += dx * k; pany -= dy * k;
  } else {
    yaw += dx * 0.008;
    pitch = Math.max(-1.55, Math.min(1.55, pitch + dy * 0.008));
  }
  drag.x = e.clientX; drag.y = e.clientY;
  requestAnimationFrame(draw);
});
cv.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.0012);
  dist = Math.max(S.extent * 0.05, Math.min(S.extent * 20, dist));
  requestAnimationFrame(draw);
}, {passive: false});
cv.addEventListener("contextmenu", e => e.preventDefault());
addEventListener("keydown", e => {
  if (e.key === "g") showGt = !showGt;
  if (e.key === "p") showPred = !showPred;
  requestAnimationFrame(draw);
});
addEventListener("resize", () => requestAnimationFrame(draw));
draw();
</script></body></html>
"""


def export_html(path, points, gt_boxes=None, pred_boxes=None,
                pred_scores=None, title="hgsfusion frame",
                max_points: int = 120000):
    """Write a standalone interactive 3D viewer for one frame.

    points: (N, >=3) lidar-frame xyz (+ optional 4th column used for point
    coloring; falls back to height). gt_boxes / pred_boxes: (M, 7) boxes
    [x y z dx dy dz heading]; corners are precomputed here so the JS stays
    geometry-free. Returns the written Path.
    """
    from .box_utils import boxes_to_corners_3d

    pts = np.asarray(points, np.float32)
    if len(pts) > max_points:  # keep the file and the canvas loop light
        sel = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[sel]
    if len(pts):
        color_src = pts[:, 3] if pts.shape[1] > 3 \
            and np.ptp(pts[:, 3]) > 1e-6 else pts[:, 2]
        lo, hi = float(color_src.min()), float(color_src.max())
        c01 = (color_src - lo) / max(hi - lo, 1e-6)
        pdata = np.round(
            np.concatenate([pts[:, :3], c01[:, None]], axis=1), 3).tolist()
    else:  # empty frame (e.g. all points masked out): boxes-only viewer
        pdata = []

    def corners(b):
        b = np.asarray(b, np.float32).reshape(-1, b.shape[-1])[:, :7]
        if not len(b):
            return []
        return np.round(np.asarray(boxes_to_corners_3d(b)), 3).tolist()

    span = pts[:, :3].max(axis=0) - pts[:, :3].min(axis=0) if len(pts) \
        else np.ones(3)
    scene = {
        "title": title,
        "points": pdata,
        "gt_boxes": corners(gt_boxes) if gt_boxes is not None else [],
        "pred_boxes": corners(pred_boxes) if pred_boxes is not None else [],
        "pred_scores": [round(float(s), 3) for s in pred_scores]
        if pred_scores is not None else None,
        "extent": float(max(np.max(span), 1.0)),
    }
    # escape the title for the <title> element and keep '<' out of the
    # inline JSON (json.dumps leaves '</script>' intact, which would
    # terminate the scene <script> block)
    import html as _html
    scene_json = json.dumps(scene, separators=(",", ":")) \
        .replace("<", "\\u003c")
    html = _HTML.replace("__TITLE__", _html.escape(title)).replace(
        "__DATA__", scene_json)
    path = Path(path)
    path.write_text(html)
    return path
