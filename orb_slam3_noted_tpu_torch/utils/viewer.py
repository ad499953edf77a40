"""Map and frame visualisation (port of :mod:`orb_slam3_noted_tpu.utils.viewer`).

The reference renders a live Pangolin window (``Viewer.cc``,
``MapDrawer::DrawMapPoints/DrawKeyFrames``, ``FrameDrawer::DrawFrame``); a
machine with a card has no display, so the map is drawn offline or served:

- :func:`map_snapshot`: the map and trajectory as plain lists (the
  covisibility product on the device, one copy back);
- :func:`save_map_png`: two orthographic panels (x-z top-down, x-y front)
  drawn by a numpy rasteriser and written by :func:`..io.images.write_png`;
- :func:`export_map_html`: one self-contained HTML file with the snapshot
  embedded and a canvas orbit viewer (the JAX package's template, byte for
  byte);
- :func:`draw_frame`: the FrameDrawer overlay in numpy, every pixel of the
  image part as ``cv2`` draws it in the JAX package, and a status bar in a
  5x7 bitmap font of this module's own;
- :class:`LiveViewer`: a daemon HTTP server with ``/`` (the orbit page,
  polling), ``/state.json`` and ``/frame.png``.

The port's map arrays are updated in place, so every read of the map here
holds the facade's ``lock``, which whoever runs ``process`` in another
thread holds too (:class:`..node.SlamNode`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from orb_slam3_noted_tpu_torch.io.images import encode_png, write_png
from orb_slam3_noted_tpu_torch.utils.interop import pull

__all__ = ["map_snapshot", "save_map_png", "render_map", "export_map_html", "LiveViewer",
           "draw_frame", "status_text", "draw_text"]

STATUS_ROWS = 22          # the status bar under the frame
MATCHED_BGR = (0, 255, 0)
UNMATCHED_BGR = (255, 80, 0)
BOX_HALF = 3              # the 7x7 box around a matched keypoint


def map_snapshot(slam) -> dict:
    """The map and trajectory as plain lists (the JAX package's keys and
    order): valid points, keyframe centres and rotations, the trajectory of
    ``slam.positions()``, covisibility edges between keyframes that share
    at least 30 points, and the counts."""
    m = slam.m
    obs = m.obs_mat.to(torch.float32)
    covis = obs @ obs.T  # sums of 0/1 counts: exact in float32
    mp_valid, mp_pos, kf_valid, kf_Rcw, kf_tcw, covis = pull(
        m.mp_valid, m.mp_pos, m.kf_valid, m.kf_Rcw, m.kf_tcw, covis)
    pts = mp_pos[mp_valid]
    Rcw, tcw = kf_Rcw[kf_valid], kf_tcw[kf_valid]
    centers = -np.einsum("kji,kj->ki", Rcw, tcw)
    traj = slam.positions() if slam.trajectory else np.zeros((0, 3))
    ii, jj = np.nonzero(np.triu(covis, 1) >= 30)
    keep = kf_valid[ii] & kf_valid[jj]
    kf_index = np.cumsum(kf_valid) - 1
    edges = (np.stack([kf_index[ii[keep]], kf_index[jj[keep]]], -1) if keep.any()
             else np.zeros((0, 2), int))
    return {
        "points": pts.tolist(),
        "kf_centers": centers.tolist(),
        "kf_Rcw": Rcw.tolist(),
        "trajectory": np.asarray(traj).tolist(),
        "covis_edges": edges.tolist(),
        "n_kf": int(kf_valid.sum()),
        "n_mp": int(mp_valid.sum()),
    }


# ---------------------------------------------------------------------------
# a 5x7 bitmap font: each glyph 7 rows of 5 bits, the high bit leftmost

_FONT_HEX = {
    "0": "0e11131519110e", "1": "040c040404040e", "2": "0e11010204081f", "3": "1f02040201110e",
    "4": "02060a121f0202", "5": "1f101e0101110e", "6": "0608101e11110e", "7": "1f010204080808",
    "8": "0e11110e11110e", "9": "0e11110f01020c",
    "A": "0e1111111f1111", "B": "1e11111e11111e", "C": "0e11101010110e", "D": "1c12111111121c",
    "E": "1f10101e10101f", "F": "1f10101e101010", "G": "0e11101711110f", "H": "1111111f111111",
    "I": "0e04040404040e", "J": "0702020202120c", "K": "11121418141211", "L": "1010101010101f",
    "M": "111b1515111111", "N": "11111915131111", "O": "0e11111111110e", "P": "1e11111e101010",
    "Q": "0e11111115120d", "R": "1e11111e141211", "S": "0f10100e01011e", "T": "1f040404040404",
    "U": "1111111111110e", "V": "11111111110a04", "W": "1111111515150a", "X": "11110a040a1111",
    "Y": "1111110a040404", "Z": "1f01020408101f",
    "a": "00000e010f110f", "b": "1010161911111e", "c": "00000e1010110e", "d": "01010d1311110f",
    "e": "00000e111f100e", "f": "0609081c080808", "g": "000f11110f010e", "h": "10101619111111",
    "i": "04000c0404040e", "j": "0200060202120c", "k": "10101214181412", "l": "0c04040404040e",
    "m": "00001a15151111", "n": "00001619111111", "o": "00000e1111110e", "p": "00001e111e1010",
    "q": "00000d130f0101", "r": "00001619101010", "s": "00000e100e011e", "t": "08081c08080906",
    "u": "0000111111130d", "v": "00001111110a04", "w": "0000111115150a", "x": "0000110a040a11",
    "y": "000011110f010e", "z": "00001f0204081f",
    ":": "000c0c000c0c00", "_": "0000000000001f", "?": "0e110102040004", "-": "0000001f000000",
    ".": "00000000000c0c", "(": "02040808080402", ")": "08040202020408", " ": "00000000000000",
}
GLYPHS = {
    ch: np.array([[(b >> (4 - k)) & 1 for k in range(5)]
                  for b in bytes.fromhex(code)], bool)
    for ch, code in _FONT_HEX.items()
}
GLYPH_ADVANCE = 6  # 5 columns and a blank one


def draw_text(img: np.ndarray, text: str, x: int, baseline: int, color) -> np.ndarray:
    """Draw ``text`` into ``img`` in place in the 5x7 font, the glyphs'
    bottom row on ``baseline``, starting at column ``x``; characters the
    font lacks are drawn as ``?``; pixels off the image are dropped."""
    H, W = img.shape[:2]
    top = baseline - 6
    for k, ch in enumerate(text):
        g = GLYPHS.get(ch, GLYPHS["?"])
        ys, xs = np.nonzero(g)
        ys, xs = ys + top, xs + x + k * GLYPH_ADVANCE
        inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        img[ys[inside], xs[inside]] = color
    return img


# ---------------------------------------------------------------------------
# the FrameDrawer overlay

# pixel offsets (dx, dy) in the order cv2 paints them: the box outline of a
# matched keypoint, then the filled radius-1 circle (a plus, not a 3x3
# square)
_R = BOX_HALF
_BOX = [(dx, dy) for dy in (-_R, _R) for dx in range(-_R, _R + 1)] + [
    (dx, dy) for dx in (-_R, _R) for dy in range(-_R + 1, _R)]
_DOT = [(0, -1), (-1, 0), (0, 0), (1, 0), (0, 1)]


def status_text(overlay: dict) -> str:
    """The status bar's text, the JAX package's string."""
    valid = np.asarray(overlay["valid"])
    matched = np.asarray(overlay["matched"])
    n_match = int((valid & matched).sum())
    return (f"{overlay.get('state', '?')}  KFs: {overlay.get('n_kf', 0)}  "
            f"MPs: {overlay.get('n_mp', 0)}  matches: {n_match}")


def _as_numpy(img) -> np.ndarray:
    return img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def draw_frame(img, overlay: dict, path: str | None = None) -> np.ndarray:
    """Keypoint overlay on the frame (reference ``FrameDrawer::DrawFrame``):
    matched keypoints in green 7x7 boxes with a dot, unmatched ones as
    blue-orange dots, in keypoint order (a later keypoint paints over an
    earlier one), then the status bar.  ``overlay`` is the dict a facade
    records with ``keep_frame_overlay`` on.  Returns (H + 22, W, 3) uint8
    in BGR order, as the JAX package's; with ``path`` also writes it as a
    PNG (RGB in the file, as ``cv2.imwrite`` stores it)."""
    im = _as_numpy(img)
    if im.ndim == 2:
        im = np.repeat(im.astype(np.uint8)[:, :, None], 3, axis=2)
    else:
        im = im.astype(np.uint8).copy()
    H, W = im.shape[:2]
    xy = np.asarray(overlay["xy"])
    valid = np.asarray(overlay["valid"]).astype(bool)
    matched = np.asarray(overlay["matched"]).astype(bool)
    idx = np.flatnonzero(valid)
    c = np.round(xy[idx]).astype(np.int64)  # half to even, as Python's round
    mt = matched[idx]
    # every pixel write as (order, x, y, matched); the last write to a pixel wins
    box, dot = np.asarray(_BOX), np.asarray(_DOT)
    k_m = np.flatnonzero(mt)
    k_u = np.flatnonzero(~mt)
    n_b, n_d = len(box), len(dot)
    offs_m = np.concatenate([box, dot])                  # a matched keypoint's writes
    order = np.concatenate([
        (k_m[:, None] * 64 + np.arange(n_b + n_d)[None]).ravel(),
        (k_u[:, None] * 64 + n_b + np.arange(n_d)[None]).ravel(),
    ])
    px = np.concatenate([(c[k_m, None, :] + offs_m[None]).reshape(-1, 2),
                         (c[k_u, None, :] + dot[None]).reshape(-1, 2)])
    green = np.concatenate([np.ones(len(k_m) * (n_b + n_d), bool), np.zeros(len(k_u) * n_d, bool)])
    inside = (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
    order, px, green = order[inside], px[inside], green[inside]
    lin = px[:, 1] * W + px[:, 0]
    srt = np.argsort(order, kind="stable")[::-1]           # last write first
    lin_s, first = np.unique(lin[srt], return_index=True)
    colors = np.where(green[srt][first, None], MATCHED_BGR, UNMATCHED_BGR).astype(np.uint8)
    im.reshape(-1, 3)[lin_s] = colors
    bar = np.zeros((STATUS_ROWS, W, 3), np.uint8)
    draw_text(bar, status_text(overlay), 6, 15, (255, 255, 255))
    out = np.concatenate([im, bar], axis=0)
    if path is not None:
        write_png(path, out[:, :, ::-1])
    return out


# ---------------------------------------------------------------------------
# the map as two orthographic panels

PANEL = 600               # pixels a side
PANEL_MARGIN = 24
PANEL_AXES = ((0, 2), (0, 1))
PANEL_TITLES = ("top (x-z)", "front (x-y)")
POINT_RGB = (0x77, 0x77, 0x77)
TRAJ_RGB = (0x15, 0x65, 0xC0)
KF_RGB = (0x2E, 0x7D, 0x32)
KF_HALF = 2               # keyframes: 5x5 squares


def _panel_projector(snap_pts: np.ndarray, a: int, b: int):
    """Pixel (column, row) in a panel of each (N, 3) point's (a, b)
    coordinates: the panel fitted to ``snap_pts`` with equal aspect, b up."""
    span = PANEL - 2 * PANEL_MARGIN
    if len(snap_pts):
        lo, hi = snap_pts[:, [a, b]].min(0), snap_pts[:, [a, b]].max(0)
    else:
        lo, hi = np.zeros(2), np.ones(2)
    scale = span / max(float((hi - lo).max()), 1e-6)
    mid = (lo + hi) / 2

    def project(p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64).reshape(-1, 3)
        u = PANEL / 2 + (p[:, a] - mid[0]) * scale
        v = PANEL / 2 - (p[:, b] - mid[1]) * scale
        return np.stack([np.round(u), np.round(v)], -1).astype(np.int64)

    return project


def _put(panel: np.ndarray, uv: np.ndarray, color) -> None:
    ok = (uv[:, 0] >= 0) & (uv[:, 0] < PANEL) & (uv[:, 1] >= 0) & (uv[:, 1] < PANEL)
    panel[uv[ok, 1], uv[ok, 0]] = color


def render_map(snap: dict):
    """(the (PANEL, 2 PANEL, 3) uint8 RGB image, one projector a panel):
    grey points, the trajectory as a blue polyline, green keyframe squares,
    each panel fitted to its data with equal aspect, titled."""
    pts = np.asarray(snap["points"], np.float64).reshape(-1, 3)
    kfs = np.asarray(snap["kf_centers"], np.float64).reshape(-1, 3)
    trj = np.asarray(snap["trajectory"], np.float64).reshape(-1, 3)
    everything = np.concatenate([pts, kfs, trj])
    panels, projectors = [], []
    for (a, b), title in zip(PANEL_AXES, PANEL_TITLES):
        panel = np.full((PANEL, PANEL, 3), 255, np.uint8)
        proj = _panel_projector(everything, a, b)
        _put(panel, proj(pts), POINT_RGB)
        if len(trj) > 1:
            q = proj(trj).astype(np.float64)
            n = np.maximum(np.abs(np.diff(q, axis=0)).max(1).astype(np.int64), 1) + 1
            seg = np.repeat(np.arange(len(q) - 1), n)
            f = np.concatenate([np.linspace(0.0, 1.0, k) for k in n])
            line = q[seg] + (q[seg + 1] - q[seg]) * f[:, None]
            _put(panel, np.round(line).astype(np.int64), TRAJ_RGB)
        elif len(trj):
            _put(panel, proj(trj), TRAJ_RGB)
        d = np.arange(-KF_HALF, KF_HALF + 1)
        sq = np.stack(np.meshgrid(d, d), -1).reshape(-1, 2)
        kq = proj(kfs)
        _put(panel, (kq[:, None, :] + sq[None]).reshape(-1, 2), KF_RGB)
        draw_text(panel, f"{title}  {snap['n_mp']} points  {snap['n_kf']} keyframes", 8, 14,
                  (0, 0, 0))
        panel[[0, -1], :] = panel[:, [0, -1]] = (0xCC, 0xCC, 0xCC)
        panels.append(panel)
        projectors.append(proj)
    return np.concatenate(panels, axis=1), projectors


def save_map_png(slam, path: str):
    """Two orthographic views (x-z top-down, x-y front) of the map, as PNG."""
    write_png(path, render_map(map_snapshot(slam))[0])
    return path


# ---------------------------------------------------------------------------
# the HTML orbit viewer: the JAX package's template

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>orb-slam3-noted-tpu map</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=0.6, pitch=0.35, dist=null, cx=0, cy=0, cz=0, drag=null;
function fit(){const P=DATA.points.concat(DATA.trajectory);
 if(!P.length){dist=10;return} let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
 for(const p of P){for(let k=0;k<3;k++){lo[k]=Math.min(lo[k],p[k]);hi[k]=Math.max(hi[k],p[k]);}}
 cx=(lo[0]+hi[0])/2;cy=(lo[1]+hi[1])/2;cz=(lo[2]+hi[2])/2;
 dist=2.2*Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3);}
function proj(p){const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pitch),cp=Math.cos(pitch);
 let x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
 let x1=cyw*x+sy*z, z1=-sy*x+cyw*z;
 let y2=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
 if(z2<1e-3)return null; const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*x1/z2, cv.height/2+f*y2/z2];}
function draw(){cv.width=innerWidth;cv.height=innerHeight;
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 ctx.fillStyle='#9e9e9e';
 for(const p of DATA.points){const q=proj(p);if(q)ctx.fillRect(q[0],q[1],1.4,1.4);}
 ctx.strokeStyle='#1e88e5';ctx.beginPath();let first=true;
 for(const p of DATA.trajectory){const q=proj(p);if(!q)continue;
  first?ctx.moveTo(q[0],q[1]):ctx.lineTo(q[0],q[1]);first=false;}
 ctx.stroke();
 ctx.strokeStyle='#2e7d3255';ctx.beginPath();
 for(const [i,j] of DATA.covis_edges){const a=proj(DATA.kf_centers[i]),b=proj(DATA.kf_centers[j]);
  if(a&&b){ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);}}
 ctx.stroke();
 ctx.fillStyle='#66bb6a';
 for(const p of DATA.kf_centers){const q=proj(p);if(q)ctx.fillRect(q[0]-2,q[1]-2,4,4);}
 document.getElementById('hud').textContent=
  `${DATA.n_kf} keyframes · ${DATA.n_mp} map points · drag to orbit, wheel to zoom`;}
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-drag[0])*0.008;
 pitch+=(e.clientY-drag[1])*0.008;drag=[e.clientX,e.clientY];draw();};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
window.onresize=draw; fit(); draw();
</script></body></html>
"""

_LIVE_SHIM = """let DATA={points:[],trajectory:[],kf_centers:[],covis_edges:[],n_kf:0,n_mp:0};
async function poll(){try{const r=await fetch('state.json');DATA=await r.json();
 if(dist===null)fit(); draw();}catch(e){} setTimeout(poll,1000);}
poll();"""


def export_map_html(slam, path: str):
    """Write a self-contained interactive 3D map viewer."""
    html = _HTML_TEMPLATE.replace("__DATA__", json.dumps(map_snapshot(slam)))
    with open(path, "w") as f:
        f.write(html)
    return path


# ---------------------------------------------------------------------------
# the live viewer (reference ``Viewer::Run``, `src/Viewer.cc:130-170`)

class LiveViewer:
    """Background HTTP server beside a running system: ``/`` the orbit page
    (polls ``state.json`` once a second), ``/state.json`` a fresh
    :func:`map_snapshot`, ``/frame.png`` :func:`draw_frame` of the last
    frame (404 until a frame was recorded with ``keep_frame_overlay`` on).

    The port's map is updated in place, so a snapshot is taken under the
    facade's ``lock``, which the thread that runs ``process`` must hold too
    (:class:`..node.SlamNode` does).  ``port=0`` binds an ephemeral port
    (``self.port``); ``close()`` stops the server."""

    def __init__(self, slam, port: int = 8765, host: str = "0.0.0.0"):
        import http.server
        import threading

        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # no per-request lines on stderr
                pass

            def do_GET(self):
                try:
                    if self.path.endswith("state.json"):
                        with viewer.lock:
                            snap = map_snapshot(viewer.slam)
                        body, ctype = json.dumps(snap).encode(), "application/json"
                    elif self.path.endswith("frame.png"):
                        with viewer.lock:
                            img = getattr(viewer.slam, "last_image", None)
                            ov = getattr(viewer.slam, "last_overlay", None)
                            img = None if img is None else _as_numpy(img)
                        if img is None or ov is None:
                            self.send_response(404)
                            self.end_headers()
                            return
                        # the BGR drawing as an RGB file, as cv2.imencode writes it
                        body, ctype = encode_png(draw_frame(img, ov)[:, :, ::-1]), "image/png"
                    else:
                        html = _HTML_TEMPLATE.replace("const DATA = __DATA__;", _LIVE_SHIM)
                        body, ctype = html.encode(), "text/html"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass

        self.slam = slam
        self.lock = slam.lock
        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()
