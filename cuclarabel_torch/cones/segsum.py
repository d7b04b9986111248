"""Segment sums of a batch's columns in one fixed order: the hand-written
kernel of `csrc/segsum.cu` and its plain PyTorch version.

  segment_sum(vals, segs) -> (B, nseg)

out[b, s] is the sum of vals[b, j] over the columns j of segment s, added
one by one in the order the segment lists them, starting from 0.  The
second-order cones' per-cone reductions (`ops._seg_sum`) and the
equilibration's rectification means (`parallel/batch.py`) run through it.
The plain version is `index_add_` on the CPU, which adds in that order;
the kernel adds in the same order and agrees with it bit for bit.  On the
card `index_add_` would add a repeated target with atomics, in an order
that changes from run to run (ROADMAP F14).  The wrapper takes the plain
version when its tensor lies on the CPU and launches the kernel when it
lies on a CUDA device.  `LAUNCHES` counts the kernel's launches under
"segment_sum" and `PLAIN_CALLS` the plain version's calls.
"""

import numpy as np
import torch

from ..kkt import _build
from ..kkt.ldl import Counts

LAUNCHES = Counts()
PLAIN_CALLS = Counts()


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


class Segments:
    """The segments of a (B, m) tensor's columns, from the segment id of
    each column (seg (m,), -1 for a column of none): `idx` (nseg, width)
    lists segment s's columns in row s, ascending, padded with -1."""

    def __init__(self, seg, device):
        seg = np.asarray(seg, dtype=np.int64).ravel()
        cols = np.flatnonzero(seg >= 0)
        ids = seg[cols]
        self.nseg = int(ids.max()) + 1 if cols.size else 0
        counts = np.bincount(ids, minlength=self.nseg)
        self.width = int(counts.max()) if cols.size else 0
        self.size = int(cols.size)
        order = np.argsort(ids, kind="stable")  # by segment, ascending
        rank = np.arange(cols.size) - np.repeat(np.cumsum(counts) - counts,
                                                counts)
        idx = np.full((self.nseg, self.width), -1, dtype=np.int32)
        idx[ids[order], rank] = cols[order]
        self.idx = torch.as_tensor(idx, device=device)
        self.seg = torch.as_tensor(ids[order], device=device)
        self.pos = torch.as_tensor(cols[order], device=device)


def segment_sum_plain(vals, segs):
    """out[b, s] = 0 + vals[b, idx[s, 0]] + vals[b, idx[s, 1]] + ...: one
    `index_add_` of the segments' entries, listed segment by segment."""
    PLAIN_CALLS.add("segment_sum")
    out = vals.new_zeros(vals.shape[0], segs.nseg)
    return out.index_add_(1, segs.seg, vals[:, segs.pos])


def segment_sum(vals, segs):
    """Per-segment sums of vals (B, m), float64 -> (B, nseg)."""
    dev = vals.device
    if dev.type == "cpu":
        return segment_sum_plain(vals, segs)
    if dev.type != "cuda" or segs.idx.device != dev:
        raise ValueError(f"vals on {dev} and the segments on "
                         f"{segs.idx.device}: both must lie on one CUDA "
                         "device")
    if vals.dim() != 2:
        raise ValueError(f"vals must be (B, m), got {tuple(vals.shape)}")
    if vals.dtype != torch.float64:
        raise TypeError(f"vals must be float64, got {vals.dtype}")
    vals = vals.contiguous()
    B, m = vals.shape
    out = torch.empty((B, segs.nseg), dtype=vals.dtype, device=dev)
    fn = _build.load().cc_segment_sum
    args = (vals.data_ptr(), segs.idx.data_ptr(), out.data_ptr(), B, m,
            segs.nseg, segs.width)
    # a sum is a few microseconds of the card's time, so the host's share
    # counts: the current device is switched only where it is another,
    # and the stream is taken as its raw handle
    if torch.cuda.current_device() == dev.index:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES.add("segment_sum", dev)
    return out
