"""Progress bars for the loops, in place of tqdm (which the card's machine
lacks).

The subset of tqdm's interface that the JAX package's loops use:
`tqdm(iterable=None, desc=None, total=None, leave=True, dynamic_ncols=False,
disable=False)` with `update`, `close`, use as an iterator and as a context
manager, and `trange`. Bars go to stderr only, never stdout, redrawn in
place at most once per MININTERVAL (0.1 s, tqdm's default `mininterval`)
and once more when they close; `leave=False` clears the line on close.
`dynamic_ncols` is accepted and ignored: the bar has a fixed width.

A bar reads the host's clock only: the loops count progress from values they
already have on the host (a finished episode, a segment's read-back), so a
bar adds no device synchronisation.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, Iterator, Optional

_WIDTH = 20  # cells of the bar
MININTERVAL = 0.1  # seconds between two draws of a bar


def _clock(seconds: float) -> str:
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    return f"{h:d}:{m:02d}:{s:02d}" if h else f"{m:02d}:{s:02d}"


class tqdm:
    """A progress bar on stderr (see the module's docstring)."""

    def __init__(self, iterable: Optional[Iterable] = None, desc: Optional[str] = None, total: Optional[float] = None,
                 leave: bool = True, dynamic_ncols: bool = False, disable: bool = False):
        if total is None and iterable is not None:
            try:
                total = len(iterable)
            except TypeError:
                total = None
        self.iterable = iterable
        self.desc = desc or ""
        self.total = total
        self.leave = leave
        self.disable = disable
        self.n = 0
        self.closed = False
        self.start = self._last_print = time.monotonic()
        self._last_len = 0
        if not disable:
            self._print()

    def __iter__(self) -> Iterator:
        try:
            for item in self.iterable:
                yield item
                self.update()
        finally:
            self.close()

    def __enter__(self) -> "tqdm":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def update(self, n: float = 1) -> None:
        self.n += n
        if self.disable:
            return
        now = time.monotonic()
        if now - self._last_print >= MININTERVAL:
            self._print(now)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.disable:
            return
        if self.leave:
            self._print()
            self._write("\n")
        else:
            self._write("\r" + " " * self._last_len + "\r")

    def _format(self, now: float) -> str:
        elapsed = now - self.start
        rate = self.n / elapsed if elapsed > 0 else 0.0
        head = f"{self.desc}: " if self.desc else ""
        count = f"{self.n:g}" if self.total is None else f"{self.n:g}/{self.total:g}"
        if self.total:
            frac = min(max(self.n / self.total, 0.0), 1.0)
            fill = int(frac * _WIDTH)
            remaining = (self.total - self.n) / rate if rate > 0 else 0.0
            return (f"{head}{100 * frac:3.0f}%|{'#' * fill}{' ' * (_WIDTH - fill)}| {count} "
                    f"[{_clock(elapsed)}<{_clock(max(remaining, 0.0))}, {rate:.2f}it/s]")
        return f"{head}{count} [{_clock(elapsed)}, {rate:.2f}it/s]"

    def _print(self, now: Optional[float] = None) -> None:
        self._last_print = time.monotonic() if now is None else now
        line = self._format(self._last_print)
        pad = " " * max(0, self._last_len - len(line))
        self._last_len = len(line)
        self._write("\r" + line + pad)

    @staticmethod
    def _write(text: str) -> None:
        stream = sys.stderr  # looked up at each write: a caller may have redirected it
        stream.write(text)
        stream.flush()


def trange(n: int, **kwargs) -> tqdm:
    """`tqdm(range(n), **kwargs)`."""
    return tqdm(range(n), **kwargs)
