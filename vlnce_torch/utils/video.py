"""Video/observability frames (host-side, off the hot path).

Port of vlnce_torch/utils/video.py (reference habitat_extensions/utils.py:
27-680): composited frames from RGB + depth + top-down map, instruction
text overlay, and disk/TensorBoard video output. Frames are drawn through
`utils/raster.py` (no OpenCV); `images_to_video` writes an uncompressed AVI
(RIFF, BI_RGB, 24-bit top-down BGR frames) where the JAX package writes an
mp4 through OpenCV, and `read_video` reads it back.
"""

from __future__ import annotations

import os
import struct
import textwrap
from typing import Dict, List, Optional

import numpy as np

from vlnce_torch.tasks.geometry import heading_from_quaternion, rtheta_to_global_coordinates
from vlnce_torch.utils import maps as map_utils
from vlnce_torch.utils import raster


def _depth_to_rgb(depth: np.ndarray) -> np.ndarray:
    d = np.clip(np.asarray(depth).squeeze(-1) if depth.ndim == 3 else depth, 0, 1)
    return (np.stack([d, d, d], axis=-1) * 255).astype(np.uint8)


def observations_to_image(observation: Dict, info: Dict, frame_height: int = 224) -> np.ndarray:
    """Compose rgb | depth | top-down-map into one frame
    (reference utils.py:27-109)."""
    panels: List[np.ndarray] = []
    if "rgb" in observation:
        rgb = np.asarray(observation["rgb"])
        if rgb.ndim == 4:  # pano [12, H, W, 3]: tile the front 4 frames
            rgb = np.concatenate([rgb[i] for i in (0, 3, 6, 9)], axis=1)
        panels.append(rgb.astype(np.uint8))
    if "depth" in observation:
        d = np.asarray(observation["depth"])
        if d.ndim == 4:
            d = d[0]
        panels.append(_depth_to_rgb(d))
    if "top_down_map_vlnce" in (info or {}):
        panels.append(map_utils.colorize_topdown_metric(info["top_down_map_vlnce"]))

    if not panels:
        return np.zeros((frame_height, frame_height, 3), np.uint8)
    scaled = []
    for p in panels:
        scale = frame_height / p.shape[0]
        scaled.append(raster.resize(p, (max(1, int(p.shape[1] * scale)), frame_height)))
    return np.concatenate(scaled, axis=1)


def pano_observations_to_image(observation: Dict, info: Dict, tile_height: int = 112) -> np.ndarray:
    """All pano frames tiled in one strip (+ depth strip + map); reference
    utils.py:112-214."""
    rgb = np.asarray(observation["rgb"])  # [P, H, W, 3]
    depth = np.asarray(observation.get("depth")) if "depth" in observation else None
    P = rgb.shape[0]
    scale = tile_height / rgb.shape[1]
    tiles = [raster.resize(rgb[i], (int(rgb.shape[2] * scale), tile_height)) for i in range(P)]
    strip = np.concatenate(tiles, axis=1)
    rows = [strip]
    if depth is not None:
        d_tiles = [
            raster.resize(_depth_to_rgb(depth[i]), (tiles[0].shape[1], tile_height)) for i in range(P)
        ]
        rows.append(np.concatenate(d_tiles, axis=1))
    frame = np.concatenate(rows, axis=0)
    if "top_down_map_vlnce" in (info or {}):
        m = map_utils.colorize_topdown_metric(info["top_down_map_vlnce"])
        mh = frame.shape[0]
        m = raster.resize(m, (int(m.shape[1] * mh / m.shape[0]), mh))
        frame = np.concatenate([frame, m], axis=1)
    return frame


def _label_band(width: int, text: str, bold: bool = False, height: int = 18,
                font_size: float = 0.45) -> np.ndarray:
    """A white strip with centered black text (the building block of the
    reference's per-pano annotation rows, utils.py:217-238,332-377)."""
    band = np.full((height, width, 3), 255, np.uint8)
    if text:
        thick = 2 if bold else 1
        tw = raster.get_text_size(text, font_size, thick)[0]
        raster.put_text(
            band, text, (max(0, (width - tw) // 2), height - 5),
            font_size, (0, 0, 0), thick, raster.LINE_AA,
        )
    return band


def _instruction_panel(height: int, width: int, text: str) -> np.ndarray:
    """White panel with wrapped instruction text (reference
    utils.py:241-267)."""
    panel = np.full((height, width, 3), 255, np.uint8)
    fs, thick = 0.45, 1
    char_w = max(1, raster.get_text_size(" ", fs, thick)[0])
    y = 6
    for line in textwrap.wrap(text or "", width=max(1, (width - 10) // char_w)):
        size = raster.get_text_size(line, fs, thick)
        y += size[1] + 8
        if y >= height - 2:
            break
        raster.put_text(panel, line, (5, y), fs, (0, 0, 0), thick, raster.LINE_AA)
    return panel


def waypoint_observations_to_image(
    observation: Dict,
    info: Dict,
    pano: Optional[int] = None,
    agent_position=None,
    agent_heading: Optional[float] = None,
    r: Optional[float] = None,
    theta: Optional[float] = None,
    tile_height: int = 112,
    pano_distribution: Optional[np.ndarray] = None,
    offset: Optional[float] = None,
    offset_mode: Optional[float] = None,
    distance: Optional[float] = None,
    distance_mode: Optional[float] = None,
    oracle_r: Optional[float] = None,
    oracle_theta: Optional[float] = None,
    instruction_text: Optional[str] = None,
) -> np.ndarray:
    """Waypoint-agent debug frame (reference utils.py:380-543): pano strip
    with index labels, per-pano probability row (selected pano bold +
    highlighted), stop-probability gauge, offset/distance step-stats band,
    predicted (and oracle) waypoints on the map, and an instruction panel.

    `pano_distribution` is the [P+1] pano-stop categorical (STOP last, the
    WaypointPolicy head layout); stats/gauge/prob rows appear only when
    their inputs are given, so existing call sites compose the same frame
    as before."""
    frame = pano_observations_to_image(observation, {}, tile_height=tile_height)
    rgb = np.asarray(observation["rgb"])
    P = rgb.shape[0]
    tile_w = frame.shape[1] // P if P else frame.shape[1]
    if pano is not None and P:
        x0 = int(pano) * tile_w
        raster.rectangle(frame, (x0, 0), (x0 + tile_w - 1, tile_height - 1), (255, 140, 0), 3)

    # per-pano annotation rows: index labels + probability labels
    if P:
        ids = np.concatenate(
            [_label_band(tile_w, str(i)) for i in range(P)], axis=1
        )
        rows = [frame[:, : tile_w * P], ids]
        if pano_distribution is not None:
            probs = np.asarray(pano_distribution).reshape(-1)
            prob_row = np.concatenate(
                [
                    _label_band(
                        tile_w, f"{probs[i]:.2f}",
                        bold=(pano is not None and i == int(pano)),
                    )
                    for i in range(min(P, len(probs)))
                ],
                axis=1,
            )
            rows.append(prob_row)
            # stop gauge: last slot of the pano-stop categorical
            if len(probs) == P + 1:
                rows.append(_label_band(
                    tile_w * P, f"stop: {probs[-1]:.2f}",
                    bold=pano is None, height=22, font_size=0.5,
                ))
        strip = np.concatenate(rows, axis=0)
        side = frame[:, tile_w * P:]
        if side.shape[1]:
            pad = np.full((strip.shape[0] - side.shape[0], side.shape[1], 3), 255, np.uint8)
            side = np.concatenate([side, pad], axis=0)
            strip = np.concatenate([strip, side], axis=1)
        frame = strip

    # step-stats band (reference add_step_stats_on_img, utils.py:269-330)
    stats = []
    if offset is not None:
        stats.append(
            f"ofst/mode: {offset:.2f}/{offset_mode:.2f}" if offset_mode is not None
            else f"ofst: {offset:.2f}"
        )
    if distance is not None:
        stats.append(
            f"dist/mode: {distance:.2f}/{distance_mode:.2f}" if distance_mode is not None
            else f"dist: {distance:.2f}"
        )
    if stats:
        frame = np.concatenate(
            [_label_band(frame.shape[1], "  ".join(stats), height=26, font_size=0.55), frame],
            axis=0,
        )

    if "top_down_map_vlnce" in (info or {}):
        metric = info["top_down_map_vlnce"]
        if agent_position is None and r is not None and "agent_map_coord" in metric:
            # reconstruct the agent's world pose from the map metric so eval
            # loops don't need to thread sim state through
            mr, mc = metric["agent_map_coord"]
            mpp = metric["meters_per_px"]
            agent_position = [mc * mpp, 0.0, mr * mpp]
            agent_heading = metric["agent_angle"] if agent_heading is None else agent_heading
        if agent_position is not None and r is not None and theta is not None:
            # draw the prediction on a copy of the index map so the yellow
            # triangle only lives in this frame (reference maps.py:256-262)
            metric = dict(metric, map=np.array(metric["map"]))
            target = rtheta_to_global_coordinates(agent_position, agent_heading or 0.0, r, theta, dimensionality=3)
            map_utils.draw_waypoint_prediction(
                metric["map"], target, metric["meters_per_px"], metric["world_size"]
            )
        if (agent_position is not None and oracle_r is not None
                and oracle_theta is not None):
            if not isinstance(metric["map"], np.ndarray) or metric is info["top_down_map_vlnce"]:
                metric = dict(metric, map=np.array(metric["map"]))
            oracle_target = rtheta_to_global_coordinates(
                agent_position, agent_heading or 0.0, oracle_r, oracle_theta,
                dimensionality=3,
            )
            map_utils.draw_oracle_waypoint(
                metric["map"], oracle_target, metric["meters_per_px"], metric["world_size"]
            )
        m = map_utils.colorize_topdown_metric(metric)
        mh = frame.shape[0]
        m = raster.resize(m, (int(m.shape[1] * mh / m.shape[0]), mh))
        if instruction_text:
            # instruction panel between the pano strip and the map
            # (reference utils.py:528-541)
            panel_w = max(60, frame.shape[1] // 4)
            frame = np.concatenate(
                [frame, _instruction_panel(mh, panel_w, instruction_text), m],
                axis=1,
            )
            instruction_text = None  # composed
        else:
            frame = np.concatenate([frame, m], axis=1)
    if instruction_text:
        # no top-down map in the measures: the instruction panel still
        # belongs on the frame (the pre-overlay compositor appended the
        # text unconditionally)
        panel_w = max(60, frame.shape[1] // 4)
        frame = np.concatenate(
            [frame, _instruction_panel(frame.shape[0], panel_w, instruction_text)],
            axis=1,
        )
    return frame


def navigator_video_frame(
    observation: Dict,
    info: Dict,
    start_pos=None,
    start_heading=None,
    action: Optional[Dict] = None,
    frame_width: int = 1024,
    map_k: str = "top_down_map_vlnce",
    instruction_text: Optional[str] = None,
) -> np.ndarray:
    """Frame for the discretized-navigator eval video (reference
    utils.py:546-637): id-labelled pano strip rotated so the rear camera sits
    at the seams, top-down map with the in-flight waypoint prediction drawn
    from the step's START pose, and an instruction panel filling the
    remaining width.

    ``start_pos``/``start_heading`` are the agent pose at the beginning of
    the waypoint step (the prediction is relative to it, not to the agent's
    current mid-plan pose); ``start_heading`` accepts a heading float or an
    [x, y, z, w] quaternion (the repo-wide convention, tasks/geometry.py).
    ``action`` is the waypoint action dict
    ({"action": ..., "action_args": {"r", "theta"}}) or None.
    ``instruction_text`` overrides the text taken from the observation (the
    production instruction obs is a token array, not text — the env passes
    the episode's instruction_text through here).
    """
    rgb = np.asarray(observation["rgb"])
    if rgb.ndim == 3:
        frames = [rgb.astype(np.uint8)]
    else:  # stacked panos [P, H, W, 3]
        frames = [rgb[i].astype(np.uint8) for i in range(rgb.shape[0])]
    # crop the horizontal overlap between adjacent pano cameras (the
    # reference crops 80 of 640 px per side, utils.py:570-573) and label
    # each tile with its camera id; a single camera has no seams to crop
    crop = frames[0].shape[1] // 8 if len(frames) > 1 else 0
    labelled = []
    for i, f in enumerate(frames):
        tile = f[:, crop: f.shape[1] - crop, :] if crop else f
        band = _label_band(tile.shape[1], str(i), height=14, font_size=0.35)
        labelled.append(np.concatenate([band, tile], axis=0))
    if len(labelled) > 1:
        # reference ordering (utils.py:574-577): reverse (cameras are
        # indexed counterclockwise, the strip reads left->right) and rotate
        # by half so the forward camera is centered
        labelled = labelled[::-1]
        half = len(labelled) // 2
        labelled = labelled[half:] + labelled[:half]
    strip = np.concatenate(labelled, axis=1)
    new_h = max(1, int(frame_width / strip.shape[1] * strip.shape[0]))
    strip = raster.resize(strip, (frame_width, new_h), raster.INTER_CUBIC)

    if instruction_text is None:
        instruction_text = _instruction_text(observation)
    metric = (info or {}).get(map_k)
    if metric is None:
        return append_text_to_image(strip, instruction_text) if instruction_text else strip

    top_down = np.array(metric["map"], copy=True)
    if (
        isinstance(action, dict)
        and isinstance(action.get("action_args"), dict)
        and start_pos is not None
        and start_heading is not None
    ):
        heading = np.asarray(start_heading, dtype=np.float64)
        if heading.ndim and heading.size == 4:
            heading = heading_from_quaternion(heading)
        else:
            heading = float(heading)
        waypoint = rtheta_to_global_coordinates(
            start_pos, heading,
            float(action["action_args"]["r"]),
            float(action["action_args"]["theta"]),
        )
        map_utils.draw_waypoint_prediction(
            top_down, waypoint, metric["meters_per_px"], metric["world_size"]
        )
    top_down = map_utils.colorize_topdown_map(
        top_down, metric.get("fog_of_war_mask"), fog_of_war_desat_amount=0.75
    )
    map_utils.draw_agent(
        top_down, metric["agent_map_coord"], metric["agent_angle"],
        metric["meters_per_px"],
    )
    if top_down.shape[0] > top_down.shape[1]:  # landscape for the bottom row
        top_down = np.rot90(top_down, 1).copy()

    map_h = max(1, strip.shape[0])
    map_w = max(1, int(top_down.shape[1] * map_h / top_down.shape[0]))
    map_w = min(map_w, frame_width)
    top_down = raster.resize(top_down, (map_w, map_h), raster.INTER_CUBIC)
    inst_w = frame_width - map_w
    if inst_w > 0:
        panel = _instruction_panel(map_h, inst_w, instruction_text)
        bottom = np.concatenate([panel, top_down], axis=1)
    else:
        bottom = top_down
    divider = np.full((24, frame_width, 3), 255, np.uint8)
    return np.concatenate([strip, divider, bottom], axis=0).astype(np.uint8)


def _instruction_text(observation: Dict) -> str:
    inst = observation.get("instruction")
    if isinstance(inst, dict):
        return str(inst.get("text", ""))
    return inst if isinstance(inst, str) else ""


def append_text_to_image(image: np.ndarray, text: str, font_size: float = 0.5) -> np.ndarray:
    """Underlay of wrapped instruction text (reference utils.py:217-280)."""
    h, w = image.shape[:2]
    words = (text or "").split()
    lines, cur = [], ""
    for word in words:
        test = (cur + " " + word).strip()
        if raster.get_text_size(test, font_size, 1)[0] > w - 10:
            lines.append(cur)
            cur = word
        else:
            cur = test
    lines.append(cur)
    line_h = int(raster.get_text_size("Ag", font_size, 1)[1] * 1.6)
    banner = np.zeros((line_h * len(lines) + 10, w, 3), np.uint8)
    for i, line in enumerate(lines):
        raster.put_text(banner, line, (5, (i + 1) * line_h), font_size, (255, 255, 255), 1)
    return np.concatenate([image, banner], axis=0)


def images_to_video(images: List[np.ndarray], output_dir: str, video_name: str, fps: int = 10) -> str:
    """Write RGB frames [H, W, 3] uint8 to `<output_dir>/<video_name>.avi`:
    an uncompressed AVI (one video stream, BI_RGB, 24-bit BGR rows padded to
    4 bytes, an idx1 index). Rows are stored top-down (a negative biHeight):
    OpenCV's FFmpeg reader corrupts its heap on bottom-up 24-bit rows. Every
    frame takes the first frame's shape."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{video_name}.avi")
    h, w = images[0].shape[:2]
    stride = (3 * w + 3) & ~3
    size = stride * h
    n = len(images)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) % 2 else b"")

    def lst(kind: bytes, payload: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", len(payload) + 4) + kind + payload

    avih = struct.pack("<14I", 1000000 // fps, size * fps, 0, 0x10, n, 0, 1, size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    frames, index = [], []
    offset = 4
    for frame in images:
        frame = np.asarray(frame, dtype=np.uint8)
        if frame.shape != (h, w, 3):
            raise ValueError(f"frame of shape {frame.shape} in a video of {(h, w, 3)}")
        rows = np.zeros((h, stride), np.uint8)
        rows[:, : 3 * w] = raster.rgb_to_bgr(frame).reshape(h, 3 * w)
        frames.append(chunk(b"00db", rows.tobytes()))
        index.append(struct.pack("<4sIII", b"00db", 0x10, offset, size))
        offset += 8 + size
    movi = lst(b"movi", b"".join(frames))
    body = b"AVI " + hdrl + movi + chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def read_video(path: str) -> np.ndarray:
    """The frames [T, H, W, 3] uint8 RGB of an AVI written by
    `images_to_video`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path} is not an AVI file")
    strf = data.index(b"strf") + 8
    _, w, h, _, bits, compression = struct.unpack_from("<IiiHHI", data, strf)
    if bits != 24 or compression != 0:
        raise ValueError(f"{path}: only 24-bit BI_RGB frames are read, not {bits}-bit, compression {compression}")
    stride = (3 * w + 3) & ~3
    pos = data.index(b"movi") + 4
    end = pos - 8 + struct.unpack_from("<I", data, pos - 8)[0] + 4
    frames = []
    while pos < end:
        fourcc, n = data[pos: pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        if fourcc == b"00db":
            rows = np.frombuffer(data, np.uint8, stride * abs(h), pos + 8).reshape(abs(h), stride)
            img = rows[:, : 3 * w].reshape(abs(h), w, 3)[:, :, ::-1]
            frames.append(img[::-1] if h > 0 else img)
        pos += 8 + n + (n % 2)
    return np.stack(frames) if frames else np.zeros((0, abs(h), w, 3), np.uint8)


def generate_video(
    video_option: List[str],
    video_dir: Optional[str],
    images: List[np.ndarray],
    episode_id: str,
    checkpoint_idx: int,
    metrics: Dict[str, float],
    tb_writer=None,
    fps: int = 10,
) -> None:
    """Write frames to disk and/or TensorBoard (reference utils.py:640-680)."""
    if len(images) < 1:
        return
    metric_strs = [f"{k}={v:.2f}" for k, v in metrics.items()]
    video_name = f"episode={episode_id}-ckpt={checkpoint_idx}-" + "-".join(metric_strs)
    if "disk" in video_option and video_dir is not None:
        images_to_video(images, video_dir, video_name, fps=fps)
    if "tensorboard" in video_option and tb_writer is not None:
        tb_writer.add_video_from_np_images(f"episode{episode_id}", checkpoint_idx, images, fps=fps)
