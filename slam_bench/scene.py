"""Inputs of the SLAM cells, made on the device from the seed: the textured
box room, the camera paths and their renders.

Frozen copies, each beside its source:

- ``room_textures``, ``render``: ``orb_slam3_noted_tpu_torch/utils/synthetic.py``
  ``BoxRoom.__init__`` (the three multi-octave textures) and
  ``BoxRoom._render_dirs`` (ray-cast against the back wall z = 8, the floor
  y = 1.5 and the side wall x = 3, bilinear texture sampling), rewritten in
  torch for the card.  The textures come from a ``torch.Generator`` on the
  device instead of numpy's, so a seed gives other textures than the
  port's ``BoxRoom(seed)``; ``render`` takes any textures, and the test
  gives it ``BoxRoom``'s to compare the two renderers.
- ``patrol_poses``: ``synthetic.smooth_pose``'s sum of sines, with its
  forward drift folded into a back and forth, so that a sequence of any
  length stays in the room as a patrol does; the amplitudes and rates come
  from the traffic file, set to a EuRoC sequence's mean speeds; the seed
  shifts the phases of the sway.
- ``so3_exp``: ``geometry/so3.py`` ``exp`` (Rodrigues) in float64.
"""

from __future__ import annotations

import torch

OCTAVES = ((4, 0.2), (16, 0.5), (64, 1.0), (256, 0.6))
ROOM = dict(depth=8.0, h=1.5, w=3.0, tex_scale=80.0)


def room_textures(gen: torch.Generator, device, tex_size: int = 2048) -> torch.Tensor:
    """(3, tex_size, tex_size) float32 textures in [0, 255]: per texture the
    four octaves of uniform noise in (-1, 1), each upsampled by repetition,
    smoothed by a [1, 2, 1] / 4 filter at half the repetition along both
    axes, weighted and summed, then stretched to [0, 255]."""
    texs = []
    for _ in range(3):
        t = torch.zeros(tex_size, tex_size, dtype=torch.float32, device=device)
        for octave, amp in OCTAVES:
            coarse = torch.rand(octave, octave, generator=gen, device=device) * 2.0 - 1.0
            reps = tex_size // octave
            up = coarse.repeat_interleave(reps, 0).repeat_interleave(reps, 1)
            k = max(reps // 2, 1)
            for ax in (0, 1):
                up = (torch.roll(up, k, ax) + 2.0 * up + torch.roll(up, -k, ax)) * 0.25
            t += amp * up
        t -= t.min()
        t *= 255.0 / max(float(t.max()), 1e-6)
        texs.append(t)
    return torch.stack(texs)


def pinhole_rays(params, width: int, height: int, device) -> torch.Tensor:
    """(H, W, 3) float64 rays with z = 1 through every pixel centre."""
    fx, fy, cx, cy = params[:4]
    xs = (torch.arange(width, dtype=torch.float64, device=device) - cx) / fx
    ys = (torch.arange(height, dtype=torch.float64, device=device) - cy) / fy
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)


def _sample(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    ts = tex.shape[0]
    u = torch.remainder(u * scale, ts - 1.001)
    v = torch.remainder(v * scale, ts - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu, fv = u - u0, v - v0
    u0, v0 = u0.long(), v0.long()
    flat = tex.reshape(-1).to(torch.float64)
    at = lambda yy, xx: flat[yy * ts + xx]
    return (at(v0, u0) * (1 - fu) * (1 - fv) + at(v0, u0 + 1) * fu * (1 - fv)
            + at(v0 + 1, u0) * (1 - fu) * fv + at(v0 + 1, u0 + 1) * fu * fv)


def render(textures: torch.Tensor, Rwc: torch.Tensor, twc: torch.Tensor, rays: torch.Tensor,
           room: dict = ROOM, with_depth: bool = False):
    """Images of the room for camera-to-world poses ``Rwc`` (N, 3, 3), ``twc``
    (N, 3) through ``rays`` (H, W, 3) in the camera frame: (N, H, W) float32
    in [0, 255] (and the ray parameter of the nearest hit, the z depth for
    rays with z = 1)."""
    R = Rwc.to(torch.float64)
    o = twc.to(torch.float64)
    dirs = torch.einsum("hwj,nij->nhwi", rays, R)
    n, hh, ww = dirs.shape[:3]
    best = torch.full((n, hh, ww), float("inf"), dtype=torch.float64, device=rays.device)
    img = torch.zeros((n, hh, ww), dtype=torch.float64, device=rays.device)
    planes = ((2, room["depth"], 0, (0, 1)), (1, room["h"], 1, (0, 2)), (0, room["w"], 2, (1, 2)))
    for axis, val, ti, (ua, va) in planes:
        d_ax = dirs[..., axis]
        t = (val - o[:, axis, None, None]) / d_ax
        valid = (t > 0.05) & torch.isfinite(t) & (t < best)
        t_safe = torch.where(valid, t, 0.0)
        hitu = o[:, ua, None, None] + t_safe * dirs[..., ua]
        hitv = o[:, va, None, None] + t_safe * dirs[..., va]
        shade = _sample(textures[ti], hitu, hitv, room["tex_scale"])
        img = torch.where(valid, shade, img)
        best = torch.where(valid, t, best)
    img = img.to(torch.float32)
    return (img, best.to(torch.float32)) if with_depth else img


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors -> (..., 3, 3) rotations (Rodrigues)."""
    th = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = torch.zeros(*w.shape[:-1], 3, 3, dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th ** 2 / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th ** 2 / 24.0, (1.0 - torch.cos(ths)) / ths ** 2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(K)
    return eye + a * K + b * (K @ K)


def patrol_poses(n: int, fps: float, phases: torch.Tensor, motion: dict, device):
    """Camera-to-world (Rwc (n, 3, 3), twc (n, 3)) float64 at frames
    0..n-1 of ``fps``: ``smooth_pose``'s form, a sum of sines, with the
    amplitudes and rates of ``motion``, about ``centre_m``: z = ``fold_m``
    sin(``fold_rad_s`` t) (a drift folded into a back and forth, so that a
    sequence of any length stays in the room), x, y and a second z term the
    sways ``sway_m`` at ``sway_rad_s`` (a large, slow x sway makes a
    traverse); pitch, yaw (about ``yaw0``) and roll the turns ``turn_rad``
    at ``turn_rad_s``.  ``phases`` (4,) shift the x, y, yaw and pitch
    sways."""
    t = torch.arange(n, dtype=torch.float64, device=device) / fps
    p = phases.to(torch.float64)
    sx, sy, sz = motion["sway_m"]
    wx, wy, wz = motion["sway_rad_s"]
    twc = torch.stack([
        sx * torch.sin(wx * t + p[0]),
        sy * torch.sin(wy * t + p[1]),
        motion["fold_m"] * torch.sin(motion["fold_rad_s"] * t) + sz * torch.sin(wz * t),
    ], dim=-1) + torch.tensor(motion["centre_m"], dtype=torch.float64, device=device)
    ap, ay, ar = motion["turn_rad"]
    wp, wyaw, wr = motion["turn_rad_s"]
    yaw = motion["yaw0"] + ay * torch.sin(wyaw * t + p[2])
    pitch = ap * torch.sin(wp * t + 0.5 + p[3])
    roll = ar * torch.sin(wr * t)
    return so3_exp(torch.stack([pitch, yaw, roll], dim=-1)), twc


def seed_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def render_stereo(textures, Rwc, twc, cam: dict, baseline: float, chunk: int = 16):
    """(left, right) (n, H, W) uint8 on the device: rectified pairs, the right
    camera ``baseline`` m along the left camera's x axis; values truncated to
    integers as the port's laps store them."""
    rays = pinhole_rays(cam["params"], cam["width"], cam["height"], textures.device)
    right_t = twc + Rwc[:, :, 0] * baseline
    out_l, out_r = [], []
    for a in range(0, Rwc.shape[0], chunk):
        sl = slice(a, a + chunk)
        out_l.append(render(textures, Rwc[sl], twc[sl], rays).to(torch.uint8))
        out_r.append(render(textures, Rwc[sl], right_t[sl], rays).to(torch.uint8))
    return torch.cat(out_l), torch.cat(out_r)


def draw_phases(gen: torch.Generator, device, spread: float = 0.2) -> torch.Tensor:
    """Four phase shifts in [-spread / 2, spread / 2) rad from the seed's
    generator: small, so that every seed gives the same path within a few
    cm and as many keyframes, and the texture sets what the frames show."""
    return (torch.rand(4, generator=gen, device=device, dtype=torch.float64) - 0.5) * spread
