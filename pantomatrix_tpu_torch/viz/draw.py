"""cv2's drawing primitives in PyTorch, batched over frames on the canvas's device: the
four that ``viz/render2d.py`` draws with (``ellipse2Poly`` + ``fillConvexPoly``, filled
``circle``, ``line`` of thickness 2), reproducing OpenCV's integer rasterization.

Each primitive becomes horizontal runs ``(frame, y, x1, x2)`` and single pixels
``(frame, y, x)`` of one layer; :func:`paint` writes all layers of a batch of frames in
one scatter, the highest layer winning a pixel (OpenCV's draw order), then looks the
layers' colours up. The algorithms follow OpenCV's ``drawing.cpp``:

- ``ellipse2Poly``: 361 vertices at 1 degree steps from its float sine table, rounded
  half to even;
- ``fillConvexPoly``: the polygon's outline (8-connected Bresenham lines for integer
  vertices, the fixed-point line for 16-bit fractional ones), then one run a row between
  the two edge chains that descend from the top vertex, each x stepped in 16.16 fixed
  point and rounded; the bottom row is left to the outline;
- ``circle`` filled with 8-connectivity: the midpoint circle's runs;
- ``line`` of thickness 2: a fixed-point rectangle filled as above, with radius-1 caps.

Lines are clipped to the canvas as ``clipLine`` clips them.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
DBL_EPSILON = 2.220446049250313e-16


@lru_cache(maxsize=8)
def _sin_table(device: torch.device) -> torch.Tensor:
    """OpenCV's SinTable: sin of 0..450 degrees to 7 decimals, as float32, widened."""
    tab = np.float32(np.round(np.sin(np.deg2rad(np.arange(451))), 7))
    return torch.as_tensor(tab.astype(np.float64), device=device)


def ellipse_poly(cx, cy, a, b: int, angle) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cv2.ellipse2Poly((cx, cy), (a, b), angle, 0, 360, 1)`` for P ellipses at once:
    int64 (P,) centres, half axes ``a`` and angles (degrees) -> (P, 361) int64 vertices
    (consecutive repeats kept; they add nothing to a fill)."""
    tab = _sin_table(cx.device)
    angle = torch.remainder(angle, 360)
    alpha, beta = tab[450 - angle][:, None], tab[angle][:, None]
    i = torch.arange(361, device=cx.device)
    x = a.to(torch.float64)[:, None] * tab[450 - i]
    y = float(b) * tab[i]
    px = cx.to(torch.float64)[:, None] + x * alpha - y * beta
    py = cy.to(torch.float64)[:, None] + x * beta + y * alpha
    return torch.round(px).to(torch.int64), torch.round(py).to(torch.int64)


def clip_line(x1, y1, x2, y2, right: int, bottom: int):
    """``cv::clipLine`` to [0, right] x [0, bottom] for many segments (int64 tensors):
    the clipped end points and whether anything is left."""
    def code(x, y):
        return ((x < 0).long() + (x > right).long() * 2 + (y < 0).long() * 4
                + (y > bottom).long() * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    act = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    f = lambda t: t.to(torch.float64)
    safe = lambda d: torch.where(d == 0, torch.ones_like(d), d)

    m = act & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, 0, bottom)
    nx = x1 + (f(a - y1) * f(x2 - x1) / f(safe(y2 - y1))).to(torch.int64)
    x1, y1 = torch.where(m, nx, x1), torch.where(m, a, y1)
    c1 = torch.where(m, (x1 < 0).long() + (x1 > right).long() * 2, c1)
    m = act & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, 0, bottom)
    nx = x2 + (f(a - y2) * f(x2 - x1) / f(safe(y2 - y1))).to(torch.int64)
    x2, y2 = torch.where(m, nx, x2), torch.where(m, a, y2)
    c2 = torch.where(m, (x2 < 0).long() + (x2 > right).long() * 2, c2)

    act = act & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = act & (c1 != 0)
    a = torch.where(c1 == 1, 0, right)
    ny = y1 + (f(a - x1) * f(y2 - y1) / f(safe(x2 - x1))).to(torch.int64)
    y1, x1 = torch.where(m, ny, y1), torch.where(m, a, x1)
    c1 = torch.where(m, 0, c1)
    m = act & (c2 != 0)
    a = torch.where(c2 == 1, 0, right)
    ny = y2 + (f(a - x2) * f(y2 - y1) / f(safe(x2 - x1))).to(torch.int64)
    y2, x2 = torch.where(m, ny, y2), torch.where(m, a, x2)
    c2 = torch.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def _expand(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For items with ``counts`` elements each: every element's item and its rank."""
    item = torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device), counts)
    start = torch.cumsum(counts, 0) - counts
    return item, torch.arange(item.shape[0], device=counts.device) - start[item]


def line_pixels(x1, y1, x2, y2, width: int, height: int):
    """``cv::Line`` (8-connected, integer end points): the pixels of S segments, as
    (segment, y, x), clipped to the canvas."""
    x1, y1, x2, y2, ok = clip_line(x1, y1, x2, y2, width - 1, height - 1)
    swap = x2 < x1  # drawn left to right
    x1, x2 = torch.where(swap, x2, x1), torch.where(swap, x1, x2)
    y1, y2 = torch.where(swap, y2, y1), torch.where(swap, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = torch.where(dy < 0, -1, 1)
    dy = dy.abs()
    vert = dy > dx
    major, minor = torch.where(vert, dy, dx), torch.where(vert, dx, dy)
    seg, k = _expand(torch.where(ok, major + 1, 0))
    mj, mn = major[seg], minor[seg]
    step = torch.div(2 * k * mn + mj - 1, (2 * mj).clamp(min=1), rounding_mode="floor")
    step = torch.where(mj == 0, 0, step)
    v = vert[seg]
    x = x1[seg] + torch.where(v, step, k)
    y = y1[seg] + sy[seg] * torch.where(v, k, step)
    return seg, y, x


def line2_pixels(x1, y1, x2, y2, width: int, height: int):
    """``cv::Line2`` (16.16 fixed-point end points): the pixels of S segments, as
    (segment, y, x), clipped to the canvas."""
    x1, y1, x2, y2, ok = clip_line(x1, y1, x2, y2, (width << XY_SHIFT) - 1,
                                   (height << XY_SHIFT) - 1)
    dx, dy = x2 - x1, y2 - y1
    ax, ay = dx.abs(), dy.abs()
    horiz = ax > ay
    swap = torch.where(horiz, dx < 0, dy < 0)
    x1, x2 = torch.where(swap, x2, x1), torch.where(swap, x1, x2)
    y1, y2 = torch.where(swap, y2, y1), torch.where(swap, y1, y2)
    dx, dy = torch.where(swap, -dx, dx), torch.where(swap, -dy, dy)
    y_step = torch.div(dy * XY_ONE, ax | 1, rounding_mode="trunc")
    x_step = torch.div(dx * XY_ONE, ay | 1, rounding_mode="trunc")
    ecount = torch.where(horiz, (x2 - x1) >> XY_SHIFT, (y2 - y1) >> XY_SHIFT)
    half = XY_ONE >> 1
    seg, k = _expand(torch.where(ok, ecount + 1, 0).clamp(min=0))
    h = horiz[seg]
    x = torch.where(h, ((x1[seg] + half) >> XY_SHIFT) + k,
                    (x1[seg] + half + k * x_step[seg]) >> XY_SHIFT)
    y = torch.where(h, (y1[seg] + half + k * y_step[seg]) >> XY_SHIFT,
                    ((y1[seg] + half) >> XY_SHIFT) + k)
    ends = torch.nonzero(ok).squeeze(1)  # the far end point, drawn first
    seg = torch.cat([ends, seg])
    x = torch.cat([(x2[ends] + half) >> XY_SHIFT, x])
    y = torch.cat([(y2[ends] + half) >> XY_SHIFT, y])
    return seg, y, x


def convex_fill(vx, vy, shift: int, width: int, height: int):
    """``cv::FillConvexPoly`` of P polygons of K vertices (int64 (P, K), ``shift``
    fraction bits; line type 8): runs (polygon, y, x1, x2), rows inside the canvas but x
    unclipped, and outline pixels (polygon, y, x)."""
    p, k = vx.shape
    dev = vx.device
    if shift not in (0, XY_SHIFT):
        raise ValueError("shift is 0 (integer vertices) or 16 (16.16 fixed point)")
    # the outline: each vertex joined to the one before it
    draw = line_pixels if shift == 0 else line2_pixels
    seg, oy, ox = draw(torch.roll(vx, 1, dims=1).reshape(-1),
                       torch.roll(vy, 1, dims=1).reshape(-1), vx.reshape(-1), vy.reshape(-1),
                       width, height)
    outline = (torch.div(seg, k, rounding_mode="floor"), oy, ox)

    # the runs: two chains from the top vertex, x stepped in 16.16 fixed point
    delta = (1 << shift) >> 1
    xf = vx * (1 << (XY_SHIFT - shift))
    ry = (vy + delta) >> shift
    imin = torch.argmin(vy, dim=1)
    ymin = ry.gather(1, imin[:, None]).squeeze(1)
    ymax = ry.max(dim=1).values
    lo, hi = ymin.clamp(min=0), torch.minimum(ymax, torch.full_like(ymax, height))
    n_rows = (hi - lo).clamp(min=0)
    r_max = int(n_rows.max()) if p else 0
    if r_max == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return (empty, empty, empty, empty), outline
    rows = lo[:, None] + torch.arange(r_max, device=dev)[None]
    valid = rows < hi[:, None]
    ar = torch.arange(k, device=dev)
    xs_at = []
    for seq in ((imin[:, None] + ar) % k, (imin[:, None] - ar) % k):
        r, x = ry.gather(1, seq), xf.gather(1, seq)
        top = torch.cummax(r, dim=1).values
        j = (torch.searchsorted(top, rows, right=True) - 1).clamp(0, k - 2)
        xs, xe = x.gather(1, j), x.gather(1, j + 1)
        ys, ye = r.gather(1, j), r.gather(1, j + 1)
        span = (ye - ys).clamp(min=1)
        dxf = torch.div((xe - xs) * 2 + span, 2 * span, rounding_mode="trunc")
        xs_at.append(xs + (rows - ys) * dxf)
    half = XY_ONE >> 1
    x1 = (torch.minimum(*xs_at) + half) >> XY_SHIFT
    x2 = (torch.maximum(*xs_at) + half) >> XY_SHIFT
    poly = torch.arange(p, device=dev)[:, None].expand(p, r_max)
    return (poly[valid], rows[valid], x1[valid], x2[valid]), outline


@lru_cache(maxsize=None)
def circle_half_widths(radius: int) -> Tuple[int, ...]:
    """The run half-width at each row offset 0..radius of ``cv::Circle`` filled."""
    hw = [-1] * (radius + 1)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        hw[dy] = max(hw[dy], dx)
        hw[dx] = max(hw[dx], dy)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return tuple(hw)


def circle_runs(cx, cy, radius: int):
    """Filled ``cv2.circle`` of C circles (int64 (C,) centres): runs (circle, y, x1, x2),
    unclipped."""
    hw = torch.as_tensor(circle_half_widths(radius), device=cx.device)
    off = torch.arange(-radius, radius + 1, device=cx.device)
    hw = hw[off.abs()]
    idx = torch.arange(cx.shape[0], device=cx.device)[:, None].expand(-1, off.shape[0])
    y = cy[:, None] + off
    return idx.reshape(-1), y.reshape(-1), (cx[:, None] - hw).reshape(-1), \
        (cx[:, None] + hw).reshape(-1)


def thick_line(x0, y0, x1, y1, width: int, height: int):
    """``cv2.line(img, p0, p1, colour, 2)`` for L segments (int64 (L,) end points): runs
    (segment, y, x1, x2) and pixels (segment, y, x). The end points are first clipped
    to the canvas grown by the thickness on each side, as ``cv::line`` does."""
    t = 2
    x0, y0, x1, y1, ok = clip_line(x0 + t, y0 + t, x1 + t, y1 + t, width + 2 * t - 1,
                                   height + 2 * t - 1)
    keep = torch.nonzero(ok).squeeze(1)
    x0, y0, x1, y1 = (v[keep] - t for v in (x0, y0, x1, y1))
    px0, py0, px1, py1 = (v * XY_ONE for v in (x0, y0, x1, y1))
    dx = (px0 - px1).to(torch.float64) / XY_ONE
    dy = (py1 - py0).to(torch.float64) / XY_ONE
    r2 = dx * dx + dy * dy
    body = torch.nonzero(r2.abs() > DBL_EPSILON).squeeze(1)
    r = float(XY_ONE) / torch.sqrt(r2[body])
    dpx = torch.round(dy[body] * r).to(torch.int64)
    dpy = torch.round(dx[body] * r).to(torch.int64)
    vx = torch.stack([px0[body] + dpx, px0[body] - dpx, px1[body] - dpx, px1[body] + dpx], 1)
    vy = torch.stack([py0[body] + dpy, py0[body] - dpy, py1[body] - dpy, py1[body] + dpy], 1)
    (ri, ry, rx1, rx2), (oi, oy, ox) = convex_fill(vx, vy, XY_SHIFT, width, height)
    runs = [(body[ri], ry, rx1, rx2)]
    for cx, cy in ((x0, y0), (x1, y1)):  # the round caps, radius (2 << 15 + half) >> 16 = 1
        runs.append(circle_runs(cx, cy, 1))
    runs = tuple(torch.cat(parts) for parts in zip(*runs))
    return (keep[runs[0]], *runs[1:]), (keep[body[oi]], oy, ox)


def paint(n: int, height: int, width: int, runs: Sequence[Tuple], pixels: Sequence[Tuple],
          palette, device) -> torch.Tensor:
    """Draw on n black frames: ``runs`` are (frame, y, x1, x2, layer) and ``pixels``
    (frame, y, x, layer) tensors, clipped or not; a pixel takes the colour
    ``palette[layer]`` (BGR) of the highest layer that covers it, as later cv2 calls
    overwrite earlier ones. -> (n, height, width, 3) uint8."""
    flat, ids = [], []
    for f, y, x1, x2, layer in runs:
        x1, x2 = x1.clamp(min=0), x2.clamp(max=width - 1)
        keep = (y >= 0) & (y < height) & (x2 >= x1)
        item, off = _expand((x2 - x1 + 1)[keep])
        f, y, x1, layer = f[keep][item], y[keep][item], x1[keep][item], layer[keep][item]
        flat.append((f * height + y) * width + x1 + off)
        ids.append(layer)
    for f, y, x, layer in pixels:
        keep = (x >= 0) & (x < width) & (y >= 0) & (y < height)
        flat.append((f[keep] * height + y[keep]) * width + x[keep])
        ids.append(layer[keep])
    canvas = torch.zeros(n * height * width, dtype=torch.int32, device=device)
    if flat:
        canvas.scatter_reduce_(0, torch.cat(flat), torch.cat(ids).to(torch.int32) + 1,
                               reduce="amax")
    colours = torch.as_tensor(np.concatenate([np.zeros((1, 3), np.uint8),
                                              np.asarray(palette, np.uint8).reshape(-1, 3)]),
                              device=device)
    return colours[canvas.long()].reshape(n, height, width, 3)


__all__ = ["circle_half_widths", "circle_runs", "clip_line", "convex_fill", "ellipse_poly",
           "line2_pixels", "line_pixels", "paint", "thick_line"]
