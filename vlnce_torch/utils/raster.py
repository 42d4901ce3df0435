"""Drawing and image primitives of the video path, in numpy on uint8 arrays.

The JAX package draws its top-down maps and video frames with OpenCV
(`vlnce_tpu/utils/{maps,video,nav_graph}.py`); the card's machine has no
OpenCV, so the port draws with these functions. Each one follows OpenCV's
integer algorithm, so that it paints the same pixels:

- `line` (LINE_8 Bresenham, and for thickness > 1 the 16-bit fixed-point
  quadrilateral with round caps), `circle` (filled), `fill_poly`
  (edge-list scan), `fill_convex_poly`, `polylines` and `rectangle`. They
  paint indicator ids into the top-down index map, which is a result of
  the eval, and colours into frames.
- `resize` with nearest, bilinear and bicubic taps: OpenCV's u8 paths
  (11-bit fixed-point bilinear weights; bicubic in f32).
- `jet` (`applyColorMap(COLORMAP_JET)` as RGB) and `rgb_to_bgr`.
- `get_text_size` (FONT_HERSHEY_SIMPLEX: each glyph's whole-pixel advance
  at the scale, and the scale's line height) and `put_text`, which stamps
  each glyph's coverage from an atlas. The tables and the atlas are
  `raster_assets.npz`, rendered by OpenCV once per style in
  `TEXT_STYLES` (`python tests/test_torch_raster.py --write-assets`, which
  its test `test_assets_match_opencv` repeats); a glyph's pixels may differ
  from OpenCV's inside the text's box, where glyphs overlap.

Points are (x, y) = (col, row), as in OpenCV. A primitive the port does not
have raises; there is no fallback to another library.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_DBL_EPSILON = 2.220446049250313e-16

INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
LINE_8 = 8
LINE_AA = 16


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round(x: float) -> int:
    """cvRound: to nearest, ties to even."""
    return int(round(x))


def _color(img: np.ndarray, color) -> np.ndarray:
    c = np.asarray(color, dtype=np.float64).reshape(-1)
    n = 1 if img.ndim == 2 else img.shape[2]
    if c.size < n:
        c = np.concatenate([c, np.zeros(n - c.size)])
    c = np.clip(np.rint(c[:n]), 0, 255).astype(img.dtype)
    return c[0] if img.ndim == 2 else c


def _hline(img, y: int, x1: int, x2: int, color) -> None:
    img[y, x1: x2 + 1] = color


# ---------------------------------------------------------------------------
# lines
# ---------------------------------------------------------------------------


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's clipLine on a w x h box: (inside, p1, p2)."""
    if w <= 0 or h <= 0:
        return False, p1, p2
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line_pixels(w: int, h: int, p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels of OpenCV's 8-connected LineIterator (left to right)."""
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        ok, p1, p2 = _clip_line(w, h, p1, p2)
        if not ok:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy, p1 = -dx, -dy, p2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    major = np.arange(max(dx, dy) + 1, dtype=np.int64)
    if dy > dx:  # steep: y is the major axis
        minor = (2 * dx * major + dy - 1) // (2 * dy)
        return p1[0] + minor, p1[1] + sy * major
    minor = (2 * dy * major + dx - 1) // (2 * dx) if dx else major * 0
    return p1[0] + major, p1[1] + sy * minor


def _line(img: np.ndarray, p1, p2, color) -> None:
    xs, ys = _line_pixels(img.shape[1], img.shape[0], p1, p2)
    img[ys, xs] = color


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's Line2: the outline of a polygon with 16-bit fixed-point
    vertices."""
    h, w = img.shape[:2]
    ok, p1, p2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not ok:
        return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        y_step = _cdiv(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        x_step = _cdiv(dx * XY_ONE, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * y_step) >> XY_SHIFT
    else:
        xs = (x1 + k * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + k
    xs = np.concatenate([[(x2 + (XY_ONE >> 1)) >> XY_SHIFT], xs])
    ys = np.concatenate([[(y2 + (XY_ONE >> 1)) >> XY_SHIFT], ys])
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _circle_fill(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's Circle with fill: the union of its horizontal spans."""
    h, w = img.shape[:2]
    cx, cy = center
    half = {}
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for off, hw in ((dy, dx), (dx, dy)):
            for y in (cy - off, cy + off):
                half[y] = max(half.get(y, -1), hw)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    for y, hw in half.items():
        if 0 <= y < h and cx - hw < w and cx + hw >= 0:
            _hline(img, y, max(cx - hw, 0), min(cx + hw, w - 1), color)


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int, flags: int) -> None:
    """OpenCV's ThickLine (LINE_8) between whole-pixel ends: a thick line is
    clipped to the image grown by its thickness, then drawn as a 16-bit
    fixed-point quadrilateral with round caps at the ends `flags` names
    (1: the first, 2: the second)."""
    if thickness <= 1:
        _line(img, p0, p1, color)
        return
    h, w = img.shape[:2]
    t = thickness
    ok, p0, p1 = _clip_line(w + 2 * t, h + 2 * t, (p0[0] + t, p0[1] + t), (p1[0] + t, p1[1] + t))
    if not ok:
        return
    p0 = ((p0[0] - t) << XY_SHIFT, (p0[1] - t) << XY_SHIFT)
    p1 = ((p1[0] - t) << XY_SHIFT, (p1[1] - t) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    half_width = thickness << (XY_SHIFT - 1)
    if abs(r) > _DBL_EPSILON:
        r = (half_width + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        _fill_convex(img, [
            (p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
            (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy),
        ], color, XY_SHIFT)
    for i, end in enumerate((p0, p1)):
        if flags & (i + 1):
            center = ((end[0] + (XY_ONE >> 1)) >> XY_SHIFT, (end[1] + (XY_ONE >> 1)) >> XY_SHIFT)
            _circle_fill(img, center, (half_width + (XY_ONE >> 1)) >> XY_SHIFT, color)


def _poly_line(img, pts, closed: bool, color, thickness: int) -> None:
    """OpenCV's PolyLine: caps at both ends of an open line's first segment,
    at the far end of every other."""
    if not pts:
        return
    p0 = pts[-1] if closed else pts[0]
    flags = 2 if closed else 3
    for p in pts[int(not closed):]:
        _thick_line(img, p0, p, color, thickness, flags)
        p0, flags = p, 2


# ---------------------------------------------------------------------------
# polygons
# ---------------------------------------------------------------------------


def _fill_convex(img: np.ndarray, v, color, shift: int) -> None:
    """OpenCV's FillConvexPoly (LINE_8), vertices at `shift` fractional bits."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    half = XY_ONE >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        ps = (p[0] << (XY_SHIFT - shift), p[1] << (XY_SHIFT - shift))
        if shift == 0:
            _line(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT), (ps[0] >> XY_SHIFT, ps[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, ps, color)
        p0 = ps
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin), dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while True:
                    edges -= 1
                    if edges + 1 <= 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e.update(ye=ty, dx=_cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)), x=xs, idx=idx)
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0]["x"] > edge[1]["x"] else (edge[0], edge[1])
            xx1 = (left["x"] + half) >> XY_SHIFT
            xx2 = (right["x"] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _collect_edges(img: np.ndarray, v, color, shift: int, edges: list) -> None:
    """OpenCV's CollectPolyEdges (LINE_8): outline drawn, edges gathered."""
    h, w = img.shape[:2]
    delta = (1 << shift) >> 1
    pt0 = (v[-1][0] << (XY_SHIFT - shift), (v[-1][1] + delta) >> shift)
    for p in v:
        pt1 = (p[0] << (XY_SHIFT - shift), (p[1] + delta) >> shift)
        t0 = ((pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1])
        _line(img, t0, t1, color)
        pt0c, pt1c = list(pt0), list(pt1)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            _, t0, t1 = _clip_line(w, h, t0, t1)
            # the clipped ends give the edge's x; an edge clipped to one
            # row keeps its rows and runs along the clipped x
            pt0c = [t0[0] << XY_SHIFT, t0[1] if t0[1] != t1[1] else pt0[1]]
            pt1c = [t1[0] << XY_SHIFT, t1[1] if t0[1] != t1[1] else pt1[1]]
        if pt0[1] != pt1[1]:
            dx = _cdiv(pt1c[0] - pt0c[0], pt1c[1] - pt0c[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], pt1[1], pt0c[0] + (pt0[1] - pt0c[1]) * dx, dx])
            else:
                edges.append([pt1[1], pt0[1], pt1c[0] + (pt1[1] - pt1c[1]) * dx, dx])
        pt0 = pt1


def _fill_edges(img: np.ndarray, edges: list, color) -> None:
    """OpenCV's FillEdgeCollection (LINE_8): even-odd spans of the active
    edges, sorted by x, on every row."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    active: List[list] = []
    i = 0
    for y in range(y_min, min(y_max, h)):
        active = [e for e in active if e[1] != y]
        while i < len(edges) and edges[i][0] == y:
            active.append(list(edges[i]))
            i += 1
        active.sort(key=lambda e: e[2])
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                x1 = (min(a[2], b[2]) + XY_ONE - 1) >> XY_SHIFT
                x2 = max(a[2], b[2]) >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    _hline(img, y, max(x1, 0), min(x2, w - 1), color)
            a[2] += a[3]
            b[2] += b[3]


def _points(pts) -> List[Tuple[int, int]]:
    return [(int(p[0]), int(p[1])) for p in np.asarray(pts).reshape(-1, 2)]


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, pt1, pt2, color, thickness)` with LINE_8."""
    _thick_line(img, tuple(map(int, pt1)), tuple(map(int, pt2)), _color(img, color), int(thickness), 3)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = -1) -> np.ndarray:
    """`cv2.circle(img, center, radius, color, -1)`: filled, LINE_8."""
    if thickness >= 0:
        raise NotImplementedError("raster.circle draws filled circles only (thickness < 0)")
    _circle_fill(img, tuple(map(int, center)), int(radius), _color(img, color))
    return img


def fill_convex_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """`cv2.fillConvexPoly(img, pts, color)` with LINE_8."""
    _fill_convex(img, _points(pts), _color(img, color), 0)
    return img


def fill_poly(img: np.ndarray, polys: Sequence, color) -> np.ndarray:
    """`cv2.fillPoly(img, polys, color)` with LINE_8."""
    c = _color(img, color)
    edges: list = []
    for pts in polys:
        _collect_edges(img, _points(pts), c, 0, edges)
    _fill_edges(img, edges, c)
    return img


def polylines(img: np.ndarray, polys: Sequence, closed: bool, color, thickness: int = 1) -> np.ndarray:
    """`cv2.polylines(img, polys, closed, color, thickness)` with LINE_8."""
    c = _color(img, color)
    for pts in polys:
        _poly_line(img, _points(pts), bool(closed), c, int(thickness))
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """`cv2.rectangle(img, pt1, pt2, color, thickness)` with LINE_8."""
    (x1, y1), (x2, y2) = tuple(map(int, pt1)), tuple(map(int, pt2))
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness >= 0:
        _poly_line(img, pts, True, _color(img, color), int(thickness))
    else:
        _fill_convex(img, pts, _color(img, color), 0)
    return img


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """OpenCV's interpolateCubic (A = -0.75), in f32."""
    x = x.astype(np.float32)
    A = np.float32(-0.75)
    one = np.float32(1)
    c0 = ((A * (x + one) - np.float32(5) * A) * (x + one) + np.float32(8) * A) * (x + one) - np.float32(4) * A
    c1 = ((A + np.float32(2)) * x - (A + np.float32(3))) * x * x + one
    c2 = ((A + np.float32(2)) * (one - x) - (A + np.float32(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def _taps(dst: int, src: int, cubic: bool, rows: bool = False):
    """Source indices [dst, k] (clamped to the edge) and f32 weights
    [dst, k] of one axis, as OpenCV's resize computes them (its bilinear
    columns past the edge take one tap; its rows keep both)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if cubic:
        idx = s[:, None] + np.arange(-1, 3)
        w = _cubic_coeffs(f)
    else:
        lo = (s < 0) & (not rows)
        f[lo], s[lo] = 0, 0
        hi = (s >= src - 1) & (not rows)
        f[hi], s[hi] = 0, src - 1
        idx = s[:, None] + np.arange(2)
        w = np.stack([np.float32(1) - f, f], axis=-1)
    return np.clip(idx, 0, src - 1), w.astype(np.float32)


def resize(img: np.ndarray, size: Tuple[int, int], interpolation: int = INTER_LINEAR) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=...)` of a uint8
    image [H, W] or [H, W, C]: nearest; bilinear with 11-bit fixed-point
    weights; bicubic (A = -0.75) in f32; edges replicated."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"raster.resize takes uint8 images, not {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if (dw, dh) == (sw, sh):
        return img.copy()
    if interpolation == INTER_NEAREST:
        ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))).astype(np.int64), sh - 1)
        xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))).astype(np.int64), sw - 1)
        return np.ascontiguousarray(img[ys[:, None], xs])
    if interpolation not in (INTER_LINEAR, INTER_CUBIC):
        raise NotImplementedError(f"raster.resize has no interpolation {interpolation}")
    if interpolation == INTER_LINEAR and sw == 2 * dw and sh == 2 * dh:
        # OpenCV takes its area path for an exact halving
        s = img.astype(np.int32)
        s = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    cubic = interpolation == INTER_CUBIC
    extra = (1,) * (img.ndim - 2)
    xi, xw = _taps(dw, sw, cubic)
    yi, yw = _taps(dh, sh, cubic, rows=True)
    # the horizontal pass runs on the source rows the vertical taps read
    used, yi = np.unique(yi, return_inverse=True)
    yi = yi.reshape(dh, -1)
    if cubic:
        # the OpenCV build the tests hold this against runs its u8 bicubic
        # in f32 with unquantized weights
        t = img[used].astype(np.float32)[:, xi]
        w = xw.reshape(dw, 4, *extra)
        rows = ((t[:, :, 0] * w[:, 0] + t[:, :, 1] * w[:, 1]) + t[:, :, 2] * w[:, 2]) + t[:, :, 3] * w[:, 3]
        r = rows[yi]
        b = yw.reshape(dh, 4, 1, *extra)
        out = ((r[:, 0] * b[:, 0] + r[:, 1] * b[:, 1]) + r[:, 2] * b[:, 2]) + r[:, 3] * b[:, 3]
        return np.ascontiguousarray(np.clip(np.rint(out), 0, 255).astype(np.uint8))
    xw = np.rint(xw * np.float32(_COEF_SCALE)).astype(np.int32)
    yw = np.rint(yw * np.float32(_COEF_SCALE)).astype(np.int32)
    t = img[used].astype(np.int32)[:, xi]
    rows = t[:, :, 0] * xw[:, 0].reshape(dw, *extra) + t[:, :, 1] * xw[:, 1].reshape(dw, *extra)
    # the vertical pass of u8 as OpenCV's vector code runs it: 16-bit
    # products of the rows shifted right by 4, then a rounding shift by 2
    b = yw.reshape(dh, 2, 1, *extra)
    acc = (((rows[yi[:, 0]] >> 4) * b[:, 0]) >> 16) + (((rows[yi[:, 1]] >> 4) * b[:, 1]) >> 16)
    return np.ascontiguousarray(np.clip((acc + 2) >> 2, 0, 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# colour tables and text (from the assets file)
# ---------------------------------------------------------------------------

ASSETS_PATH = os.path.join(os.path.dirname(__file__), "raster_assets.npz")
# the (font scale, thickness, line type) combinations the video path draws
TEXT_STYLES = ((0.35, 1, LINE_AA), (0.45, 1, LINE_AA), (0.45, 2, LINE_AA), (0.5, 1, LINE_AA),
               (0.5, 2, LINE_AA), (0.55, 1, LINE_AA), (0.5, 1, LINE_8))
_ASSETS = None


def style_key(font_scale: float, thickness: int, line_type: int) -> str:
    return f"s{int(round(font_scale * 100)):03d}_t{min(int(thickness), 2)}_{'aa' if line_type == LINE_AA else 'l8'}"


def _assets():
    global _ASSETS
    if _ASSETS is None:
        with np.load(ASSETS_PATH) as z:
            _ASSETS = {k: z[k] for k in z.files}
    return _ASSETS


def jet() -> np.ndarray:
    """[256, 3] uint8 RGB: OpenCV's COLORMAP_JET."""
    return _assets()["jet_rgb"]


def rgb_to_bgr(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[..., ::-1])


def _style(font_scale: float, thickness: int, line_type: int) -> str:
    key = style_key(font_scale, thickness, line_type)
    if key + "_adv" not in _assets():
        raise NotImplementedError(
            f"no text metrics for font scale {font_scale}, thickness {thickness}, "
            f"line type {line_type}: raster.TEXT_STYLES lists the ones in {os.path.basename(ASSETS_PATH)}"
        )
    return key


def _codes(text: str) -> np.ndarray:
    """Atlas rows of the characters; one outside printable ASCII (which the
    atlas does not hold) is drawn and measured as '?'."""
    codes = np.array([ord(c) - 32 for c in text], np.int64)
    codes[(codes < 0) | (codes > 94)] = ord("?") - 32
    return codes


def get_text_size(text: str, font_scale: float, thickness: int) -> Tuple[int, int]:
    """(width, height) as `cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX,
    font_scale, thickness)[0]` gives them: the glyphs' whole-pixel advances
    at this scale plus one, and the scale's line height (0, 0 for "")."""
    if not text:
        return 0, 0
    a = _assets()
    key = _style(font_scale, thickness, LINE_AA)  # the sizes do not depend on the line type
    return int(a[key + "_adv"][_codes(text)].sum()) + 1, int(a[key + "_height"])


def put_text(img: np.ndarray, text: str, org, font_scale: float, color, thickness: int = 1,
             line_type: int = LINE_8) -> np.ndarray:
    """`cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, ...)`: each glyph's
    coverage from the atlas, placed at its whole-pixel advance from `org`
    (the baseline's left end), blended over the image."""
    if not text:
        return img
    a = _assets()
    key = _style(font_scale, thickness, line_type)
    glyphs, adv = a[key + "_glyphs"], a[key + "_adv"]
    oy, ox = (int(v) for v in a[key + "_origin"])
    codes = _codes(text)
    gh, gw = glyphs.shape[1:]
    xs = int(org[0]) + ox + np.concatenate([[0], np.cumsum(adv[codes])[:-1]])
    y0 = int(org[1]) + oy
    x_lo, x_hi = int(xs[0]), int(xs[-1]) + gw
    cov = np.zeros((gh, x_hi - x_lo), np.uint8)
    for code, x in zip(codes, xs):
        win = cov[:, x - x_lo: x - x_lo + gw]
        np.maximum(win, glyphs[code], out=win)
    h, w = img.shape[:2]
    r0, r1 = max(y0, 0), min(y0 + gh, h)
    c0, c1 = max(x_lo, 0), min(x_hi, w)
    if r0 >= r1 or c0 >= c1:
        return img
    cov = cov[r0 - y0: r1 - y0, c0 - x_lo: c1 - x_lo].astype(np.int32)
    if img.ndim == 3:
        cov = cov[..., None]
    dst = img[r0:r1, c0:c1].astype(np.int32)
    col = _color(img, color).astype(np.int32)
    img[r0:r1, c0:c1] = (dst + ((col - dst) * cov + 127) // 255).astype(img.dtype)
    return img
