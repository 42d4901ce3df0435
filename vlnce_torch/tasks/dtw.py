"""Dynamic time warping: exact DTW and the FastDTW O(n) approximation.

Replaces the `dtw` and `fastdtw` dependencies used by the reference NDTW
measure (reference habitat_extensions/measures.py:8,249,283-291). The exact
DTW is a vectorized numpy row sweep; FastDTW follows the published algorithm
(Salvador & Chan, 2007): recursive 2x coarsening, low-res warp path, then a
radius-expanded window search at full resolution. Both return the DTW
distance for sequences of d-dimensional points under the euclidean metric.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _as_array(seq) -> np.ndarray:
    a = np.asarray(seq, dtype=np.float64)
    if a.ndim == 1:
        a = a[:, None]
    return a


def dtw(x, y) -> float:
    """Exact DTW distance (euclidean point metric), O(n*m) vectorized."""
    x, y = _as_array(x), _as_array(y)
    n, m = len(x), len(y)
    # pairwise distances row by row keeps memory at O(m)
    prev = np.full(m + 1, np.inf)
    prev[0] = 0.0
    cur = np.empty(m + 1)
    for i in range(n):
        d = np.linalg.norm(y - x[i], axis=1)
        cur[0] = np.inf
        # cur[j] = d[j-1] + min(prev[j-1], prev[j], cur[j-1]) — the cur[j-1]
        # term is a prefix dependency, so sweep scalars over one row.
        best_prev = np.minimum(prev[:-1], prev[1:])
        running = np.inf
        for j in range(m):
            running = d[j] + min(best_prev[j], running)
            cur[j + 1] = running
        prev, cur = cur, prev
    return float(prev[m])


def _reduce_by_half(x: np.ndarray) -> np.ndarray:
    n = len(x) - (len(x) % 2)
    return (x[0:n:2] + x[1:n:2]) / 2.0


def _expand_window(path: List[Tuple[int, int]], len_x: int, len_y: int, radius: int):
    path_set = set(path)
    for i, j in path:
        for a in range(-radius, radius + 1):
            for b in range(-radius, radius + 1):
                path_set.add((i + a, j + b))
    # project each low-res cell to the 2x2 block at full resolution
    window_set = set()
    for i, j in path_set:
        for a, b in ((i * 2, j * 2), (i * 2, j * 2 + 1), (i * 2 + 1, j * 2), (i * 2 + 1, j * 2 + 1)):
            window_set.add((a, b))
    # monotone column ranges per row
    window: List[Tuple[int, int]] = []
    start_j = 0
    for i in range(len_x):
        new_start_j = None
        for j in range(start_j, len_y):
            if (i, j) in window_set:
                window.append((i, j))
                if new_start_j is None:
                    new_start_j = j
            elif new_start_j is not None:
                break
        if new_start_j is not None:
            start_j = new_start_j
    return window


def _dtw_windowed(x: np.ndarray, y: np.ndarray, window: Optional[Sequence[Tuple[int, int]]]):
    n, m = len(x), len(y)
    if window is None:
        window = [(i, j) for i in range(n) for j in range(m)]
    window = [(i + 1, j + 1) for i, j in window]
    D: Dict[Tuple[int, int], Tuple[float, int, int]] = {(0, 0): (0.0, 0, 0)}
    for i, j in window:
        dt = float(np.linalg.norm(x[i - 1] - y[j - 1]))
        candidates = []
        for prev in ((i - 1, j), (i, j - 1), (i - 1, j - 1)):
            if prev in D:
                candidates.append((D[prev][0] + dt, prev[0], prev[1]))
        if not candidates:
            continue
        D[(i, j)] = min(candidates, key=lambda t: t[0])
    dist, pi, pj = D[(n, m)]
    path = []
    i, j = n, m
    while (i, j) != (0, 0):
        path.append((i - 1, j - 1))
        _, pi, pj = D[(i, j)]
        i, j = pi, pj
    path.reverse()
    return dist, path


def _fastdtw_rec(x: np.ndarray, y: np.ndarray, radius: int):
    min_time_size = radius + 2
    if len(x) < min_time_size or len(y) < min_time_size:
        return _dtw_windowed(x, y, None)
    x_shrunk = _reduce_by_half(x)
    y_shrunk = _reduce_by_half(y)
    _, low_res_path = _fastdtw_rec(x_shrunk, y_shrunk, radius)
    window = _expand_window(low_res_path, len(x), len(y), radius)
    return _dtw_windowed(x, y, window)


def fastdtw(x, y, radius: int = 1) -> float:
    """FastDTW approximate distance (matches the `fastdtw` package default
    radius=1 used by the reference)."""
    x, y = _as_array(x), _as_array(y)
    dist, _ = _fastdtw_rec(x, y, radius)
    return float(dist)
