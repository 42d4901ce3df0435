"""The port's frame composers and video files (`vlnce_torch/utils/video.py`)
held against the JAX package's on the same observations and infos.

Frames must have JAX's shape. With the text drawing turned off on both
sides (OpenCV's putText in the JAX package, `raster.put_text` in the port)
every pixel must be equal, except where a frame is resized bicubically:
there within one level, with at least 99% exact. With text on, only glyph
pixels may differ. Videos are uncompressed AVI files that `read_video` reads
back bit for bit, and that OpenCV's decoder reads too.
"""

from __future__ import annotations

import os
import types

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vlnce_tpu.utils import maps as jmaps  # noqa: E402
from vlnce_tpu.utils import video as jvideo  # noqa: E402
from vlnce_torch.envs.gridworld import get_scene  # noqa: E402
from vlnce_torch.utils import raster  # noqa: E402
from vlnce_torch.utils import video as tvideo  # noqa: E402
from vlnce_torch.utils.tensorboard import TensorboardWriter  # noqa: E402

TEXT = "walk past the sofa, turn left at the kitchen and stop next to the fridge near the window"


@pytest.fixture
def no_text(monkeypatch):
    monkeypatch.setattr(cv2, "putText", lambda img, *a, **k: img)
    monkeypatch.setattr(raster, "put_text", lambda img, *a, **k: img)


def _metric(resolution=256, seed=0):
    rng = np.random.default_rng(seed)
    sim = types.SimpleNamespace(_scene=get_scene("synth_scene_2"))
    index = jmaps.make_top_down_index_map(sim, resolution)
    jmaps.drawline(index, (40, 50), (int(rng.integers(60, resolution)), int(rng.integers(60, resolution))), 90,
                   thickness=max(1, resolution // 91))
    return {
        "map": index,
        "fog_of_war_mask": (rng.random(sim._scene.occupancy.shape) < 0.6).astype(np.uint8),
        "agent_map_coord": (int(rng.integers(20, resolution - 20)), int(rng.integers(20, resolution - 20))),
        "agent_angle": float(rng.uniform(-np.pi, np.pi)),
        "meters_per_px": 16.0 / resolution,
        "world_size": 16.0,
    }


def _obs(seed=0, pano=0, h=48, w=64):
    rng = np.random.default_rng(seed)
    shape = (pano,) if pano else ()
    return {"rgb": rng.integers(0, 256, shape + (h, w, 3), dtype=np.uint8),
            "depth": rng.random(shape + (h, w, 1), dtype=np.float32)}


def _assert_close_frames(a, b, cubic=False):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    if not cubic:
        np.testing.assert_array_equal(a, b)
        return
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.99


def _composers():
    """(name, composer call, resized bicubically) over both packages."""
    m1024, m256 = _metric(1024, 1), _metric(256, 2)
    probs = np.random.default_rng(3).dirichlet(np.ones(13)).astype(np.float32)
    wp = dict(pano=4, r=1.25, theta=0.6, pano_distribution=probs, offset=0.1, offset_mode=0.05,
              distance=1.5, distance_mode=1.25, instruction_text=TEXT)
    yield "observations_to_image", lambda v: v.observations_to_image(_obs(1), {"top_down_map_vlnce": m1024}), False
    yield "observations_to_image_pano", lambda v: v.observations_to_image(_obs(2, 12), {"top_down_map_vlnce": m256}), False
    yield "observations_to_image_no_map", lambda v: v.observations_to_image(_obs(3), {}), False
    yield "append_text_to_image", lambda v: v.append_text_to_image(v.observations_to_image(_obs(1), {}), TEXT), False
    yield "pano_observations_to_image", lambda v: v.pano_observations_to_image(_obs(4, 12), {"top_down_map_vlnce": m256}), False
    yield "waypoint_observations_to_image", lambda v: v.waypoint_observations_to_image(
        _obs(5, 12), {"top_down_map_vlnce": m1024}, **wp), False
    yield "waypoint_stop_no_map", lambda v: v.waypoint_observations_to_image(
        _obs(6, 12), {}, **dict(wp, pano=None, oracle_r=0.8, oracle_theta=-0.3)), False
    yield "waypoint_oracle", lambda v: v.waypoint_observations_to_image(
        _obs(7, 12), {"top_down_map_vlnce": m256}, agent_position=[8.0, 0.0, 8.0], agent_heading=0.4,
        oracle_r=0.8, oracle_theta=-0.3, **wp), False
    yield "navigator_video_frame", lambda v: v.navigator_video_frame(
        _obs(8, 12), {"top_down_map_vlnce": m1024}, start_pos=[7.0, 0.0, 9.0], start_heading=[0.0, 0.38, 0.0, 0.92],
        action={"action": "GO_TOWARD_POINT", "action_args": {"r": 1.5, "theta": 0.3}}, instruction_text=TEXT), True
    yield "navigator_single_camera", lambda v: v.navigator_video_frame(
        _obs(9, 0, 64, 96), {}, instruction_text=TEXT), True


COMPOSERS = list(_composers())


@pytest.mark.parametrize("name,call,cubic", COMPOSERS, ids=[c[0] for c in COMPOSERS])
def test_frames_match_jax_outside_text(no_text, name, call, cubic):
    _assert_close_frames(call(jvideo), call(tvideo), cubic)


@pytest.mark.parametrize("name,call,cubic", COMPOSERS, ids=[c[0] for c in COMPOSERS])
def test_frames_with_text_keep_jax_shape(name, call, cubic):
    a, b = call(jvideo), call(tvideo)
    assert a.shape == b.shape
    differ = (a != b).any(-1).mean()
    assert differ < 0.005, differ  # glyph pixels only (at most 0.022% of a frame here)


def test_label_and_instruction_layout_match_jax(no_text):
    """The bands' text positions and the wrapped panel come from the text
    sizes: with the glyphs stamped as blocks, the frames stay equal."""
    for w, s in ((60, "0.93"), (300, "stop: 0.50"), (900, "ofst/mode: 0.12/0.50  dist/mode: 1.50/1.25")):
        for bold in (False, True):
            np.testing.assert_array_equal(jvideo._label_band(w, s, bold), tvideo._label_band(w, s, bold))
    np.testing.assert_array_equal(jvideo._instruction_panel(200, 160, TEXT), tvideo._instruction_panel(200, 160, TEXT))


def test_avi_round_trip_and_opencv_decodes_it(tmp_path):
    rng = np.random.default_rng(0)
    for h, w in ((33, 45), (224, 672)):  # rows padded to 4 bytes, and not
        frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(7)]
        path = tvideo.images_to_video(frames, str(tmp_path), f"v{w}", fps=10)
        assert path.endswith(f"v{w}.avi")
        np.testing.assert_array_equal(tvideo.read_video(path), np.stack(frames))
        cap = cv2.VideoCapture(path)
        decoded = []
        while True:
            ok, img = cap.read()
            if not ok:
                break
            decoded.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        cap.release()
        assert len(decoded) == len(frames)
        np.testing.assert_array_equal(np.stack(decoded), np.stack(frames))
    with pytest.raises(ValueError):
        tvideo.images_to_video([frames[0], frames[0][:-1]], str(tmp_path), "bad")


def test_generate_video_names_match_jax(tmp_path):
    frames = [np.full((16, 24, 3), i * 20, np.uint8) for i in range(4)]
    for option in (["disk"], ["disk", "tensorboard"]):
        for v, sub in ((jvideo, "jax"), (tvideo, "port")):
            v.generate_video(option, str(tmp_path / sub), frames, "ep7", 3, {"spl": 0.4567, "success": 1.0})
    names = {sub: sorted(os.path.splitext(f) for f in os.listdir(tmp_path / sub)) for sub in ("jax", "port")}
    assert [n for n, _ in names["jax"]] == [n for n, _ in names["port"]] == ["episode=ep7-ckpt=3-spl=0.46-success=1.00"]
    assert [e for _, e in names["jax"]] == [".mp4"] and [e for _, e in names["port"]] == [".avi"]
    np.testing.assert_array_equal(tvideo.read_video(str(tmp_path / "port" / "episode=ep7-ckpt=3-spl=0.46-success=1.00.avi")),
                                  np.stack(frames))
    tvideo.generate_video(["disk"], str(tmp_path / "none"), [], "ep8", 0, {})
    assert not (tmp_path / "none").exists()


def test_tensorboard_video_without_writer_does_nothing():
    w = TensorboardWriter("")
    w.add_video_from_np_images("episode0", 1, [np.zeros((4, 4, 3), np.uint8)] * 2)
    assert w.writer is None
