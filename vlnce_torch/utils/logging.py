"""Framework logger (habitat.logger equivalent, reference run.py:56-59)."""

from __future__ import annotations

import logging
import sys


class _Logger(logging.Logger):
    def __init__(self):
        super().__init__("vlnce_torch", logging.INFO)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        self.addHandler(handler)

    def add_filehandler(self, log_file: str) -> None:
        handler = logging.FileHandler(log_file)
        handler.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        self.addHandler(handler)


logger = _Logger()
