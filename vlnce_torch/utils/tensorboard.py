"""TensorBoard writer wrapper.

Replaces habitat's TensorboardWriter for scalars (reference
habitat_extensions/utils.py:18). It does nothing when no logdir is given or
the tensorboard package is absent, so trainers can write unconditionally;
`add_video_from_np_images` logs an eval episode's frames (utils/video.py).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class TensorboardWriter:
    def __init__(self, log_dir: str, flush_secs: int = 30, purge_step: Optional[int] = None):
        self.writer = None
        if log_dir:
            # torch's SummaryWriter needs the tensorboard package: degrade to
            # a warning where it is absent
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                import logging

                logging.getLogger("vlnce_torch").warning(
                    "tensorboard unavailable (package not installed); "
                    f"TENSORBOARD_DIR={log_dir!r} will not be written"
                )
                return

            self.writer = SummaryWriter(log_dir=log_dir, flush_secs=flush_secs, purge_step=purge_step)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        if self.writer is not None:
            self.writer.close()

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def add_scalars(self, tag: str, value_dict, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalars(tag, {k: float(v) for k, v in value_dict.items()}, step)

    def add_video_from_np_images(self, video_name: str, step_idx: int, images: List[np.ndarray], fps: int = 10) -> None:
        """images: list of [H, W, 3] uint8 frames."""
        if self.writer is None:
            return
        import torch

        frames = np.stack(images, axis=0)  # [T, H, W, 3]
        video = torch.from_numpy(frames[None].transpose(0, 1, 4, 2, 3))  # [1, T, 3, H, W]
        self.writer.add_video(video_name, video, global_step=step_idx, fps=fps)
