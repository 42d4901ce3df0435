"""The port's drawing and image primitives (`vlnce_torch/utils/raster.py`)
held against OpenCV, which the JAX package draws with.

Index-map primitives (line, circle, fillPoly, fillConvexPoly, polylines,
rectangle) and nearest / bilinear resize must equal OpenCV exactly; bicubic
resize within one level on at least 99% exact pixels; text sizes exactly;
text glyphs only inside their boxes. The sweeps are seeded, over thicknesses
1 to 12 and images of 64 to 1024 pixels a side, with shapes clipped at the
edges.

The text tables, glyph atlas and JET table that the port reads
(`vlnce_torch/utils/raster_assets.npz`) are made by `build_assets` below:
`python tests/test_torch_raster.py --write-assets` writes them, and
`test_assets_match_opencv` rebuilds them and compares.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2") if __name__ != "__main__" else __import__("cv2")

from vlnce_torch.utils import raster  # noqa: E402

FONT = 0  # cv2.FONT_HERSHEY_SIMPLEX
SIZES = (64, 128, 256, 512, 1024)


def build_assets() -> dict:
    """The JET table, and per text style the glyphs' whole-pixel advances,
    the line height, and each printable glyph rendered alone by OpenCV at
    origin (0, 0) (its window's offset from the origin in `_origin`)."""
    out = {"jet_rgb": cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET).reshape(256, 3)[:, ::-1].copy()}
    pad = 64
    for scale, thick, line_type in raster.TEXT_STYLES:
        key = raster.style_key(scale, thick, line_type)
        chars = [chr(c) for c in range(32, 127)]
        out[key + "_adv"] = np.array([cv2.getTextSize(c, FONT, scale, thick)[0][0] - 1 for c in chars], np.int32)
        out[key + "_height"] = np.int32(cv2.getTextSize("A", FONT, scale, thick)[0][1])
        canvas = np.zeros((len(chars), 2 * pad, 2 * pad), np.uint8)
        for i, c in enumerate(chars):
            cv2.putText(canvas[i], c, (pad, pad), FONT, scale, 255, thick, line_type)
        ys, xs = np.nonzero(canvas.any(0))
        out[key + "_glyphs"] = canvas[:, ys.min(): ys.max() + 1, xs.min(): xs.max() + 1].copy()
        out[key + "_origin"] = np.array([ys.min() - pad, xs.min() - pad], np.int32)
    return out


def test_assets_match_opencv():
    built = build_assets()
    with np.load(raster.ASSETS_PATH) as z:
        assert sorted(z.files) == sorted(built)
        for k, v in built.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def _point(rng, n, margin=0.3):
    m = int(n * margin)
    return int(rng.integers(-m, n + m)), int(rng.integers(-m, n + m))


def _canvas(rng, channels=0):
    h, w = int(rng.choice(SIZES)), int(rng.choice(SIZES))
    return np.zeros((h, w, channels) if channels else (h, w), np.uint8)


@pytest.mark.parametrize("thickness", range(1, 13))
def test_line_matches_opencv(thickness):
    rng = np.random.default_rng(thickness)
    for _ in range(40):
        a = _canvas(rng)
        p1, p2 = _point(rng, a.shape[1]), _point(rng, a.shape[0])
        if rng.random() < 0.5:  # short segments, as a step of the agent's trail
            p2 = (p1[0] + int(rng.integers(-20, 21)), p1[1] + int(rng.integers(-20, 21)))
        b = a.copy()
        cv2.line(a, p1, p2, 17, thickness)
        raster.line(b, p1, p2, 17, thickness)
        np.testing.assert_array_equal(a, b, err_msg=f"{p1} {p2} {a.shape}")


def test_line_on_rgb_matches_opencv():
    rng = np.random.default_rng(0)
    for _ in range(40):
        a = _canvas(rng, 3)
        p1, p2, t = _point(rng, a.shape[1]), _point(rng, a.shape[0]), int(rng.integers(1, 13))
        b = a.copy()
        cv2.line(a, p1, p2, (0, 200, 0), t)
        raster.line(b, p1, p2, (0, 200, 0), t)
        np.testing.assert_array_equal(a, b)


def test_circle_matches_opencv():
    rng = np.random.default_rng(1)
    for i in range(200):
        a = _canvas(rng, 3 if i % 2 else 0)
        c, r = _point(rng, min(a.shape[:2])), int(rng.integers(0, 41))
        b = a.copy()
        cv2.circle(a, c, r, (0, 200, 0), -1)
        raster.circle(b, c, r, (0, 200, 0), -1)
        np.testing.assert_array_equal(a, b, err_msg=f"{c} {r}")


def test_fill_poly_matches_opencv():
    rng = np.random.default_rng(2)
    for i in range(300):
        a = _canvas(rng)
        n = min(a.shape)
        if i % 2:  # draw_triangle's shape, centred anywhere near the map
            x, y = _point(rng, n, 0.05)
            p = int(rng.integers(2, 40))
            pts = np.array([[x, y - p], [x - p, y + p], [x + p, y + p]], np.int32)
        else:
            pts = np.array([_point(rng, n) for _ in range(int(rng.integers(3, 8)))], np.int32)
        b = a.copy()
        cv2.fillPoly(a, [pts.reshape(-1, 1, 2)], 12)
        raster.fill_poly(b, [pts], 12)
        np.testing.assert_array_equal(a, b, err_msg=f"{pts.tolist()} {a.shape}")


def test_fill_convex_poly_matches_opencv():
    rng = np.random.default_rng(3)
    for _ in range(200):
        a = _canvas(rng)
        c = np.array(_point(rng, min(a.shape)))
        ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 9))))
        pts = (c + np.stack([np.cos(ang), np.sin(ang)], 1) * rng.uniform(2, 200)).astype(np.int32)
        b = a.copy()
        cv2.fillConvexPoly(a, pts, 9)
        raster.fill_convex_poly(b, pts, 9)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("closed", [False, True])
def test_polylines_matches_opencv(closed):
    rng = np.random.default_rng(4 + closed)
    for _ in range(120):
        a = _canvas(rng)
        pts = np.array([_point(rng, min(a.shape)) for _ in range(int(rng.integers(2, 8)))], np.int32)
        t = int(rng.integers(1, 13))
        b = a.copy()
        cv2.polylines(a, [pts], closed, 14, thickness=t)
        raster.polylines(b, [pts], closed, 14, thickness=t)
        np.testing.assert_array_equal(a, b)


def test_rectangle_matches_opencv():
    rng = np.random.default_rng(6)
    for _ in range(120):
        a = _canvas(rng, 3)
        p1, p2, t = _point(rng, a.shape[1]), _point(rng, a.shape[0]), int(rng.integers(-1, 13))
        t = t or 1
        b = a.copy()
        cv2.rectangle(a, p1, p2, (255, 140, 0), t)
        raster.rectangle(b, p1, p2, (255, 140, 0), t)
        np.testing.assert_array_equal(a, b)


RESIZES = [((1024, 1024), (224, 224)), ((256, 256), (224, 224)), ((64, 64), (1024, 1024)),
           ((480, 640), (224, 298)), ((224, 224), (112, 112)), ((48, 64), (112, 149)),
           ((224, 2688), (103, 1236)), ((138, 1344), (103, 1024)), ((256, 256), (103, 103))]


def _resize_cases(seed):
    rng = np.random.default_rng(seed)
    shapes = RESIZES + [((int(rng.integers(2, 300)), int(rng.integers(2, 300))),
                         (int(rng.integers(1, 300)), int(rng.integers(1, 300)))) for _ in range(20)]
    for i, ((sh, sw), (dh, dw)) in enumerate(shapes):
        img = rng.integers(0, 256, (sh, sw, 3) if i % 2 else (sh, sw), dtype=np.uint8)
        if i % 3 == 0:
            img = cv2.GaussianBlur(img, (5, 5), 2)
        yield img, (dw, dh)


@pytest.mark.parametrize("interp", ["nearest", "linear"])
def test_resize_matches_opencv_exactly(interp):
    flag = {"nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR}[interp]
    for img, size in _resize_cases(7):
        np.testing.assert_array_equal(cv2.resize(img, size, interpolation=flag), raster.resize(img, size, flag))


def test_resize_cubic_within_one_level():
    exact = total = 0
    for img, size in _resize_cases(8):
        a = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
        d = np.abs(a.astype(int) - raster.resize(img, size, raster.INTER_CUBIC).astype(int))
        assert d.max() <= 1
        exact += int((d == 0).sum())
        total += d.size
    assert exact / total >= 0.99


PRINTABLE = [chr(c) for c in range(32, 127)]


@pytest.mark.parametrize("style", raster.TEXT_STYLES, ids=lambda s: raster.style_key(*s))
def test_text_size_matches_opencv(style):
    scale, thick, _ = style
    rng = np.random.default_rng(int(scale * 100) + thick)
    strings = ["", " ", "Ag", "stop: 0.93", "ofst/mode: 0.12/0.50"] + PRINTABLE
    strings += ["".join(rng.choice(PRINTABLE, int(rng.integers(1, 80)))) for _ in range(300)]
    for s in strings:
        assert raster.get_text_size(s, scale, thick) == tuple(cv2.getTextSize(s, FONT, scale, thick)[0]), s


@pytest.mark.parametrize("style", raster.TEXT_STYLES, ids=lambda s: raster.style_key(*s))
def test_put_text_differs_only_inside_its_box(style):
    """Glyph pixels may differ from OpenCV's (the atlas is stamped per glyph);
    nothing outside the text's box may, and most of the box agrees."""
    scale, thick, line_type = style
    rng = np.random.default_rng(int(scale * 100) + 10 * thick + line_type)
    for _ in range(20):
        bg, fg = ((255, 255, 255), (0, 0, 0)) if rng.random() < 0.5 else ((0, 0, 0), (255, 255, 255))
        a = np.full((60, 400, 3), bg, np.uint8)
        s = "".join(rng.choice(PRINTABLE, int(rng.integers(1, 40))))
        org = (int(rng.integers(-5, 20)), int(rng.integers(10, 50)))
        b = a.copy()
        cv2.putText(a, s, org, FONT, scale, fg, thick, line_type)
        raster.put_text(b, s, org, scale, fg, thick, line_type)
        w, h = raster.get_text_size(s, scale, thick)
        box = np.zeros(a.shape[:2], bool)
        box[max(org[1] - h - 2, 0): org[1] + h // 2 + 2, max(org[0] - 2, 0): org[0] + w + 2] = True
        diff = (a != b).any(-1)
        assert not (diff & ~box).any(), s
        assert diff.sum() <= 0.1 * box.sum(), s


def test_jet_and_bgr():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET).reshape(256, 3)
    np.testing.assert_array_equal(raster.jet(), lut[:, ::-1])
    img = np.random.default_rng(9).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(raster.rgb_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def test_text_outside_printable_ascii_is_drawn_as_question_marks():
    img = np.zeros((30, 120, 3), np.uint8)
    assert raster.get_text_size("caf\u00e9 \u0928\t", 0.5, 1) == raster.get_text_size("caf? ??", 0.5, 1)
    np.testing.assert_array_equal(raster.put_text(img.copy(), "\u2019x", (2, 20), 0.5, (255, 255, 255)),
                                  raster.put_text(img.copy(), "?x", (2, 20), 0.5, (255, 255, 255)))


def test_missing_primitives_raise():
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(NotImplementedError):
        raster.resize(img, (4, 4), 3)  # INTER_AREA
    with pytest.raises(NotImplementedError):
        raster.get_text_size("x", 0.7, 1)
    with pytest.raises(NotImplementedError):
        raster.circle(img, (4, 4), 2, 1, thickness=1)


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-assets"]:
        np.savez_compressed(raster.ASSETS_PATH, **build_assets())
        print("wrote", raster.ASSETS_PATH)
