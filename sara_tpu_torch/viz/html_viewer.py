"""Self-contained interactive HTML point-cloud / trajectory viewer.

Twin of ``sara_tpu/viz/html_viewer.py`` (NumPy + json).

The interactivity analog of the reference's OpenGL scenes
(reference: cpp/src/DO/Kalpana/EasyGL/SimpleSceneRenderer/PointCloudScene.hpp
with its trackball camera) for headless servers: writes one HTML file
with an embedded canvas renderer (orbit/zoom controls, no external deps) so
reconstructions can be inspected in any browser.
"""

from __future__ import annotations

import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>sara-tpu point cloud</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body><canvas id="c"></canvas><div id="hud">drag: orbit &nbsp; wheel: zoom
&nbsp; shift-drag: pan</div>
<script>
const PTS = __POINTS__;
const COLS = __COLORS__;
const TRAJ = __TRAJ__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=0.5, pitch=0.4, dist=__DIST__, cx=0, cy=0;
const center = __CENTER__;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize', resize);
function proj(p){
  const sy=Math.sin(yaw), cyw=Math.cos(yaw), sp=Math.sin(pitch), cp=Math.cos(pitch);
  let x=p[0]-center[0], y=p[1]-center[1], z=p[2]-center[2];
  let x1=cyw*x+sy*z, z1=-sy*x+cyw*z;
  let y2=cp*y-sp*z1, z2=sp*y+cp*z1;
  z2+=dist;
  if(z2<0.1) return null;
  const f=0.9*Math.min(cv.width,cv.height);
  return [cv.width/2+f*x1/z2+cx, cv.height/2+f*y2/z2+cy, z2];
}
function draw(){
  ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
  for(let i=0;i<PTS.length;i++){
    const q=proj(PTS[i]); if(!q) continue;
    const s=Math.max(1, 4/Math.sqrt(q[2]));
    ctx.fillStyle=COLS[i];
    ctx.fillRect(q[0], q[1], s, s);
  }
  if(TRAJ.length>1){
    ctx.strokeStyle='#ff5050';ctx.lineWidth=2;ctx.beginPath();
    let started=false;
    for(const p of TRAJ){const q=proj(p); if(!q) continue;
      if(!started){ctx.moveTo(q[0],q[1]);started=true;}else ctx.lineTo(q[0],q[1]);}
    ctx.stroke();
  }
}
let drag=false, panning=false, lx=0, ly=0;
cv.onmousedown=e=>{drag=true;panning=e.shiftKey;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;
  if(panning){cx+=e.clientX-lx; cy+=e.clientY-ly;}
  else {yaw+=(e.clientX-lx)*0.008; pitch+=(e.clientY-ly)*0.008;}
  lx=e.clientX;ly=e.clientY;draw();};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
resize();
</script></body></html>
"""


def write_html_viewer(path: str, points: np.ndarray, colors=None,
                      trajectory=None, max_points: int = 50_000):
    """Write an interactive viewer for a point cloud (+ optional trajectory)."""
    p = np.asarray(points, float)
    if len(p) > max_points:
        sel = np.random.RandomState(0).choice(len(p), max_points, replace=False)
        p = p[sel]
        colors = None if colors is None else np.asarray(colors)[sel]
    if colors is None:
        cols = ["#8ab4f8"] * len(p)
    else:
        c8 = (np.clip(np.asarray(colors, float), 0, 1) * 255).astype(int)
        cols = ["#%02x%02x%02x" % tuple(c) for c in c8]
    traj = np.asarray(trajectory, float).tolist() if trajectory is not None else []
    center = p.mean(axis=0).tolist() if len(p) else [0, 0, 0]
    spread = float(np.abs(p - np.asarray(center)).max()) if len(p) else 1.0
    html = (_TEMPLATE
            .replace("__POINTS__", json.dumps(np.round(p, 4).tolist()))
            .replace("__COLORS__", json.dumps(cols))
            .replace("__TRAJ__", json.dumps(traj))
            .replace("__CENTER__", json.dumps(center))
            .replace("__DIST__", str(3.0 * spread + 1.0)))
    with open(path, "w") as f:
        f.write(html)
    return path
