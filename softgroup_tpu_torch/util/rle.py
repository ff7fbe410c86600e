"""Run-length encoding of 1-D binary instance masks (memory compression for
result collection).

Wire-compatible with the reference format (`softgroup/util/rle.py:5-39`):
``dict(length=N, counts="s1 n1 s2 n2 ...")`` where ``s`` are 1-based start
positions of the 1-runs and ``n`` their lengths.
"""

from __future__ import annotations

import numpy as np


def rle_encode(mask: np.ndarray) -> dict:
    mask = np.asarray(mask).ravel()
    n = mask.size
    m = (mask != 0).astype(np.int8)
    dif = np.diff(m, prepend=0, append=0)
    starts = np.nonzero(dif == 1)[0] + 1           # 1-based
    ends = np.nonzero(dif == -1)[0] + 1
    lengths = ends - starts
    counts = ' '.join(
        f'{int(s)} {int(l)}' for s, l in zip(starts, lengths))
    return dict(length=int(n), counts=counts)


def rle_decode(rle: dict) -> np.ndarray:
    out = np.zeros(rle['length'], np.uint8)
    vals = rle['counts'].split()
    for i in range(0, len(vals), 2):
        s = int(vals[i]) - 1
        out[s:s + int(vals[i + 1])] = 1
    return out
