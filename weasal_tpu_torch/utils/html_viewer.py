"""Self-contained interactive 3-D point-cloud viewer (one HTML file).

Counterpart of weasal_tpu/utils/html_viewer.py (`colors_to_rgb` :45,
`export_html` :89): the point data embedded as base64 Float32 / Uint8
arrays, a small WebGL renderer with mouse orbit, zoom and pan, and
keyboard frame stepping; the file opens in any browser with no network
or plugin. The same inputs give the same bytes as the JAX package's.

Interaction: drag = orbit, wheel = zoom, right-drag / shift-drag = pan,
left / right arrows (or g / h) = previous / next frame, space (or k) =
play / pause, + / - = point size, b = toggle the layers, r = reset the
camera. `layers` are always drawn (a context cloud); `frames` one at a
time (the levels of a pyramid, or deformed kernels).
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

# The tab10 palette (0-255 RGB)
_TAB10 = np.array([
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207)], dtype=np.uint8)

# 8-stop viridis ramp for scalar fields (potentials, probabilities, z)
_VIRIDIS = np.array([
    (68, 1, 84), (70, 50, 127), (54, 92, 141), (39, 127, 143),
    (31, 161, 136), (74, 194, 110), (160, 218, 57), (253, 231, 37)],
    dtype=np.float32)


def colors_to_rgb(points: np.ndarray,
                  colors: Optional[np.ndarray]) -> np.ndarray:
    """[N,3] uint8 from labels (palette), scalars (ramp), RGB, or height."""
    n = points.shape[0]
    if colors is None:
        colors = points[:, 2]                      # height ramp
    colors = np.asarray(colors)
    if colors.ndim == 2 and colors.shape[1] == 3:
        c = colors.astype(np.float32)
        if c.max() <= 1.0 + 1e-6:
            c = c * 255.0
        return np.clip(c, 0, 255).astype(np.uint8)
    flat = colors.reshape(n)
    if np.issubdtype(flat.dtype, np.integer):
        return _TAB10[np.abs(flat.astype(np.int64)) % len(_TAB10)]
    lo, hi = float(np.min(flat)), float(np.max(flat))
    t = (flat.astype(np.float32) - lo) / (hi - lo if hi > lo else 1.0)
    x = t * (len(_VIRIDIS) - 1)
    i = np.clip(x.astype(np.int32), 0, len(_VIRIDIS) - 2)
    f = (x - i)[:, None]
    return (_VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f).astype(np.uint8)


def _pack(points: np.ndarray, colors: Optional[np.ndarray],
          name: str, size: float, max_points: int) -> dict:
    points = np.ascontiguousarray(np.asarray(points, np.float32))
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"layer '{name}': points must be [N,3], "
                         f"got {points.shape}")
    rgb = colors_to_rgb(points, colors)
    if points.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(points.shape[0], max_points,
                                              replace=False)
        points, rgb = points[sel], rgb[sel]
    return {
        "name": name,
        "n": int(points.shape[0]),
        "size": float(size),
        "pos": base64.b64encode(points.tobytes()).decode("ascii"),
        "col": base64.b64encode(np.ascontiguousarray(rgb).tobytes())
               .decode("ascii"),
    }


def export_html(path: str,
                layers: Sequence[Tuple] = (),
                frames: Sequence[Tuple] = (),
                title: str = "weasal_tpu viewer",
                legend: Optional[Sequence[str]] = None,
                max_points: int = 400_000) -> str:
    """Write a standalone interactive viewer.

    layers / frames: sequences of (name, points[N,3], colors, point_size);
    colors may be None (height ramp), int labels (tab10 palette), scalars
    (viridis ramp) or [N,3] RGB. All layers render together; exactly one
    frame renders at a time (keyboard-stepped).
    """
    packed_layers = [_pack(p, c, nm, s, max_points)
                     for (nm, p, c, s) in layers]
    packed_frames = [_pack(p, c, nm, s, max_points)
                     for (nm, p, c, s) in frames]
    if not packed_layers and not packed_frames:
        raise ValueError("export_html needs at least one layer or frame")
    legend_items = []
    if legend:
        legend_items = [{"name": str(nm),
                         "rgb": [int(v) for v in _TAB10[i % len(_TAB10)]]}
                        for i, nm in enumerate(legend)]
    payload = json.dumps({"layers": packed_layers, "frames": packed_frames,
                          "legend": legend_items, "title": title})
    # Layer/frame names and titles come from caller paths: escape "</" so a
    # literal "</script>" inside the JSON cannot terminate the script block,
    # and HTML-escape the title used in markup.
    payload = payload.replace("</", "<\\/")
    import html as _html
    html = _TEMPLATE.replace("__TITLE__", _html.escape(title)).replace(
        "__PAYLOAD__", payload)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#111;
  font:12px/1.4 system-ui,sans-serif;color:#ddd}
canvas{display:block;width:100vw;height:100vh}
#hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.55);
  padding:8px 10px;border-radius:6px;max-width:330px;pointer-events:none}
#hud b{color:#fff}
.sw{display:inline-block;width:10px;height:10px;border-radius:2px;
  margin:0 4px -1px 0}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<script>
"use strict";
const DATA = __PAYLOAD__;
function decode(b64, Arr){
  const s = atob(b64), u = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) u[i] = s.charCodeAt(i);
  return new Arr(u.buffer);
}
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:false});
const VS = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
uniform float psize; varying vec3 vc;
void main(){ gl_Position = mvp*vec4(p,1.0);
  gl_PointSize = max(1.0, psize/(0.3+gl_Position.w)); vc = col/255.0; }`;
const FS = `precision mediump float; varying vec3 vc;
void main(){ gl_FragColor = vec4(vc,1.0); }`;
function shader(type, src){
  const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s);
  if(!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const aP = gl.getAttribLocation(prog, "p");
const aC = gl.getAttribLocation(prog, "col");
const uM = gl.getUniformLocation(prog, "mvp");
const uS = gl.getUniformLocation(prog, "psize");

let lo = [1e30,1e30,1e30], hi = [-1e30,-1e30,-1e30];
function upload(spec){
  const pos = decode(spec.pos, Float32Array);
  const col = decode(spec.col, Uint8Array);
  for (let i = 0; i < spec.n; i++)
    for (let a = 0; a < 3; a++){
      const v = pos[3*i+a];
      if (v < lo[a]) lo[a] = v; if (v > hi[a]) hi[a] = v;
    }
  const bp = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, bp);
  gl.bufferData(gl.ARRAY_BUFFER, pos, gl.STATIC_DRAW);
  const bc = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, bc);
  gl.bufferData(gl.ARRAY_BUFFER, col, gl.STATIC_DRAW);
  return {n:spec.n, name:spec.name, size:spec.size, bp, bc};
}
const layers = DATA.layers.map(upload);
const frames = DATA.frames.map(upload);
const ctr = [(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const span = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2], 1e-6);

let yaw = 0.6, pitch = 0.9, dist = 1.8, panX = 0, panY = 0;
let frameIdx = 0, playing = false, showBase = true, sizeMul = 1.0;
function mat(){
  const w = canvas.width, h = canvas.height, asp = w/h;
  const f = 2.2, n = 0.01*span, fr = 50*span;
  const P = [f/asp,0,0,0, 0,f,0,0, 0,0,(fr+n)/(n-fr),-1,
             0,0,2*fr*n/(n-fr),0];
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  // orbit: translate(-ctr) -> Rz(yaw) -> Rx(pitch) -> translate(z=-dist)
  const R = [cy, sy*cp, sy*sp, 0,
             -sy, cy*cp, cy*sp, 0,
             0, -sp, cp, 0,
             0, 0, 0, 1];
  const t = [ -(R[0]*ctr[0]+R[4]*ctr[1]+R[8]*ctr[2]) + panX,
              -(R[1]*ctr[0]+R[5]*ctr[1]+R[9]*ctr[2]) + panY,
              -(R[2]*ctr[0]+R[6]*ctr[1]+R[10]*ctr[2]) - dist*span ];
  const V = R.slice(); V[12]=t[0]; V[13]=t[1]; V[14]=t[2];
  const M = new Float32Array(16);
  for (let i = 0; i < 4; i++)
    for (let j = 0; j < 4; j++){
      let s = 0;
      for (let k = 0; k < 4; k++) s += P[k*4+j]*V[i*4+k];
      M[i*4+j] = s;
    }
  return M;
}
function drawObj(o){
  gl.bindBuffer(gl.ARRAY_BUFFER, o.bp);
  gl.enableVertexAttribArray(aP);
  gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 0, 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, o.bc);
  gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC, 3, gl.UNSIGNED_BYTE, false, 0, 0);
  gl.uniform1f(uS, o.size*sizeMul*span);
  gl.drawArrays(gl.POINTS, 0, o.n);
}
function hud(){
  let t = "<b>"+(DATA.title||"viewer")+"</b><br>";
  if (showBase) for (const o of layers) t += o.name+" ("+o.n+" pts)<br>";
  if (frames.length){
    const f = frames[frameIdx];
    t += "frame "+(frameIdx+1)+"/"+frames.length+": "+f.name+" ("+f.n+
         " pts)"+(playing ? " [playing]" : "")+"<br>";
  }
  for (const it of DATA.legend)
    t += '<span class="sw" style="background:rgb('+it.rgb.join(",")+
         ')"></span>'+it.name+"<br>";
  t += "<i>drag orbit / wheel zoom / shift-drag pan<br>"+
       "arrows or g/h frame, space or k play, +/- size, b base, r reset"+
       "</i>";
  document.getElementById("hud").innerHTML = t;
}
function render(){
  const w = canvas.clientWidth*devicePixelRatio;
  const h = canvas.clientHeight*devicePixelRatio;
  if (canvas.width !== w || canvas.height !== h){
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.07, 0.07, 0.08, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  gl.uniformMatrix4fv(uM, false, mat());
  if (showBase) for (const o of layers) drawObj(o);
  if (frames.length) drawObj(frames[frameIdx]);
  hud();
}
let drag = null;
canvas.addEventListener("mousedown", e => {
  drag = {x:e.clientX, y:e.clientY, pan:(e.shiftKey || e.button === 2)};
});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX-drag.x, dy = e.clientY-drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan){ panX += dx*0.0012*span*dist; panY -= dy*0.0012*span*dist; }
  else {
    yaw += dx*0.008;
    pitch = Math.min(3.1, Math.max(0.0, pitch+dy*0.008));
  }
  render();
});
canvas.addEventListener("contextmenu", e => e.preventDefault());
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY*0.0012);
  render();
}, {passive:false});
function step(d){
  if (frames.length){
    frameIdx = (frameIdx+d+frames.length) % frames.length; render();
  }
}
window.addEventListener("keydown", e => {
  if (e.key === "ArrowRight" || e.key === "h") step(1);
  else if (e.key === "ArrowLeft" || e.key === "g") step(-1);
  else if (e.key === " " || e.key === "k"){
    playing = !playing; render();
  }
  else if (e.key === "+" || e.key === "="){ sizeMul *= 1.3; render(); }
  else if (e.key === "-"){ sizeMul /= 1.3; render(); }
  else if (e.key === "b"){ showBase = !showBase; render(); }
  else if (e.key === "r"){
    yaw = 0.6; pitch = 0.9; dist = 1.8; panX = panY = 0; sizeMul = 1;
    render();
  }
});
setInterval(() => { if (playing) step(1); }, 120);
window.addEventListener("resize", render);
render();
</script></body></html>
"""
