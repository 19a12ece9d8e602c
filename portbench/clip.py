"""The seeded test clip: camera-like motion over a textured scene.

One segment of ``n`` I420 frames (uint8, packed Y then U then V) made
from a seed on a torch device and copied to the host once:

- a textured background panning at ``pan`` pixels a frame (quarter-pel
  speeds with a fraction, so motion compensation interpolates), in a
  direction the seed picks;
- textured ``objects`` that enter from the picture's edges at their own
  speeds, so P pictures code intra MBs where they uncover the scene;
- sensor noise drawn uniformly from -``noise`` .. ``noise`` on every
  sample.

All arithmetic is integer (quarter-pel bilinear sampling with rounding),
so a seed gives the same frames on every device of a kind.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _smooth_texture(g, h: int, w: int, cell: int, device) -> torch.Tensor:
    """int32 (h, w) texture in 0..255: noise on a grid of ``cell`` pixels,
    upsampled bilinearly, plus finer octaves."""
    out = torch.zeros((h, w), dtype=torch.float32, device=device)
    amp = 1.0
    total = 0.0
    for c in (cell, max(2, cell // 4), max(1, cell // 16)):
        gh, gw = h // c + 2, w // c + 2
        coarse = torch.rand((1, 1, gh, gw), generator=g, device=device)
        up = torch.nn.functional.interpolate(
            coarse, size=(gh * c, gw * c), mode="bilinear",
            align_corners=False)[0, 0, :h, :w]
        out += amp * up
        total += amp
        amp *= 0.5
    return torch.round(out / total * 219.0 + 16.0).to(torch.int32)


def _randint(g, lo: int, hi: int, device) -> int:
    """An integer in lo .. hi - 1 from the generator."""
    return int(torch.randint(lo, hi, (1,), generator=g, device=device))


def _sample_q(tex: torch.Tensor, y0_q: int, x0_q: int, h: int,
              w: int) -> torch.Tensor:
    """The (h, w) window of ``tex`` whose top-left corner lies at
    (y0_q / 4, x0_q / 4) pixels, bilinear at quarter-pel, rounded."""
    yi, fy = y0_q >> 2, y0_q & 3
    xi, fx = x0_q >> 2, x0_q & 3
    a = tex[yi:yi + h, xi:xi + w]
    b = tex[yi:yi + h, xi + 1:xi + 1 + w]
    c = tex[yi + 1:yi + 1 + h, xi:xi + w]
    d = tex[yi + 1:yi + 1 + h, xi + 1:xi + 1 + w]
    return ((4 - fx) * (4 - fy) * a + fx * (4 - fy) * b +
            (4 - fx) * fy * c + fx * fy * d + 8) >> 4


def make_segment(seed: int, width: int, height: int, n: int, *,
                 pan=(2.25, 0.75), objects=((0.2, 0.15, 4.25, 0.05),),
                 noise: int = 3, device="cuda") -> list:
    """``n`` packed I420 frames (numpy uint8 rows of one host array) of
    the clip drawn from ``seed``.

    ``pan``: the pan's speeds in pixels a frame across and down; the
    seed picks their signs.  ``objects``: (height and width as shares of
    the picture's, speed in pixels a frame, the share of the segment
    before it reaches the picture's edge) of each object, the i-th
    entering from the left, right, top and bottom edge for i = 0, 1, 2,
    3 (mod 4); the seed picks where along the edge, and every texture and
    colour.  So every seed makes the same amount of motion and of newly
    uncovered picture, in another direction and place."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    H, W = height, width
    vx, vy = (v if _randint(g, 0, 2, dev) else -v for v in pan)
    M = int(math.ceil(max(abs(vx), abs(vy)) * n)) + 8
    scale = max(1, W // 240)
    bg = _smooth_texture(g, H + 2 * M, W + 2 * M, 16 * scale, dev)
    bgc = [_smooth_texture(g, H // 2 + M + 8, W // 2 + M + 8, 8 * scale,
                           dev) // 2 + 64 for _ in range(2)]

    objs = []
    for i, (fh, fw, speed, share) in enumerate(objects):
        oh, ow = max(4, int(H * fh)), max(4, int(W * fw))
        side = i % 4
        across = float(torch.rand((1,), generator=g, device=dev))
        d = speed * share * n     # distance to the edge
        if side == 0:
            y, x, dy, dx = across * (H - oh), -ow - d, 0.0, speed
        elif side == 1:
            y, x, dy, dx = across * (H - oh), W + d, 0.0, -speed
        elif side == 2:
            y, x, dy, dx = -oh - d, across * (W - ow), speed, 0.0
        else:
            y, x, dy, dx = H + d, across * (W - ow), -speed, 0.0
        tex = _smooth_texture(g, oh + 2, ow + 2, 4 * scale, dev)
        uv = [_randint(g, 40, 216, dev) for _ in range(2)]
        objs.append((round(y * 4), round(x * 4), round(dy * 4),
                     round(dx * 4), oh, ow, tex, uv))

    out = torch.empty((n, H * W * 3 // 2), dtype=torch.uint8, device=dev)
    for t in range(n):
        oy, ox = round(vy * t * 4), round(vx * t * 4)
        Y = _sample_q(bg, 4 * M + oy, 4 * M + ox, H, W)
        U, V = (_sample_q(c, 2 * M + oy // 2, 2 * M + ox // 2, H // 2,
                          W // 2) for c in bgc)
        for y_q, x_q, dy_q, dx_q, oh, ow, tex, uv in objs:
            py, px = y_q + dy_q * t, x_q + dx_q * t
            top, left = py >> 2, px >> 2
            y0, y1 = max(0, top), min(H, top + oh)
            x0, x1 = max(0, left), min(W, left + ow)
            if y0 >= y1 or x0 >= x1:
                continue
            # the texture moves with the object: sample it at the
            # object's own quarter-pel phase
            patch = _sample_q(tex, 4 - (py & 3), 4 - (px & 3), oh, ow)
            Y[y0:y1, x0:x1] = patch[y0 - top:y1 - top, x0 - left:x1 - left]
            cy0, cy1, cx0, cx1 = y0 // 2, (y1 + 1) // 2, x0 // 2, (x1 + 1) // 2
            U[cy0:cy1, cx0:cx1] = uv[0]
            V[cy0:cy1, cx0:cx1] = uv[1]
        planes = []
        for p in (Y, U, V):
            p = p + torch.randint(-noise, noise + 1, p.shape, generator=g,
                                  device=dev, dtype=torch.int32)
            planes.append(p.clamp(0, 255).to(torch.uint8).reshape(-1))
        out[t] = torch.cat(planes)
    host = out.cpu().numpy()
    return [host[t] for t in range(n)]


def checksum(frames) -> str:
    """A short digest of a clip (for the tests and the logs)."""
    import hashlib
    h = hashlib.sha1()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()[:16]
