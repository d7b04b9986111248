"""Sums over repeated targets in a fixed order.

The reference's sparse paths add values into slots that repeat within
one scatter (`x.at[idx].add`, `jax.ops.segment_sum`).  On CUDA,
`index_add_` and `scatter_add_` sum a repeated target with atomics, in
an order that changes from run to run, so two solves of one problem
would differ in their last bits.  The plans here are built once on the
host from the index arrays, and every sum runs in one fixed order, so
results are bitwise reproducible on the card (and on the CPU):

  * `Scatter`: out[:, idx[k]] += vals[:, k] where a target repeats a few
    times (a front slot receiving a K entry and its children's updates):
    one `index_add_` per round, each round holding at most one entry per
    target, in the order the entries come;
  * `SegmentSum`: y[:, seg[k]] = sum of vals[:, k] where a target may
    repeat thousands of times (a dense row of A in a sparse product):
    each segment is cut into chunks of `width` entries, every chunk is
    summed along a padded axis, and the chunk sums are summed the same
    way until one value per segment is left.
"""

import numpy as np
import torch


class Scatter:
    """out[:, idx[k]] += vals[:, k] in rounds of distinct targets."""

    def __init__(self, idx, device):
        idx = np.asarray(idx, dtype=np.int64).ravel()
        self.size = idx.shape[0]
        order = np.argsort(idx, kind="stable")
        sidx = idx[order]
        # rank of each entry among the entries of its target, in order
        start = np.ones(sidx.shape[0], dtype=bool)
        start[1:] = sidx[1:] != sidx[:-1]
        first = np.maximum.accumulate(np.where(start, np.arange(sidx.size),
                                               0)) if sidx.size else sidx
        rank = np.arange(sidx.size) - first
        self.rounds = []
        for r in range(int(rank.max()) + 1 if rank.size else 0):
            sel = np.sort(order[rank == r])
            pos = None if (r == 0 and sel.size == self.size) else (
                torch.as_tensor(sel, device=device))
            self.rounds.append((pos, torch.as_tensor(idx[sel],
                                                     device=device)))

    def add_(self, out, vals):
        """out (B, S) += the entries of vals (B, size); returns out."""
        for pos, tgt in self.rounds:
            src = vals if pos is None else vals.index_select(1, pos)
            out.index_add_(1, tgt, src)
        return out


class SegmentSum:
    """y[:, s] = sum of vals[:, k] over seg[k] == s, in a fixed order."""

    def __init__(self, seg, num_segments: int, device, width: int = 8):
        seg = np.asarray(seg, dtype=np.int64).ravel()
        self.num_segments = int(num_segments)
        self.size = seg.shape[0]
        order = np.argsort(seg, kind="stable")
        items = order                       # entry ids, by segment
        segs = seg[order]
        self.stages = []
        while True:
            # chunks of `width` consecutive items of one segment
            start = np.ones(segs.shape[0], dtype=bool)
            start[1:] = segs[1:] != segs[:-1]
            first = (np.maximum.accumulate(
                np.where(start, np.arange(segs.size), 0))
                if segs.size else segs)
            rank = np.arange(segs.size) - first
            chunk_start = start | (rank % width == 0)
            chunk = np.cumsum(chunk_start) - 1
            nchunk = int(chunk[-1]) + 1 if chunk.size else 0
            idx = np.full((nchunk, width), -1, dtype=np.int64)
            idx[chunk, rank % width] = items
            chunk_seg = segs[chunk_start]
            self.stages.append(torch.as_tensor(idx, device=device))
            if nchunk == np.unique(chunk_seg).size:
                break
            items = np.arange(nchunk)
            segs = chunk_seg
        self.out_seg = torch.as_tensor(chunk_seg, device=device)

    def __call__(self, vals):
        """vals (B, size) -> (B, num_segments)."""
        B = vals.shape[0]
        v = vals
        for idx in self.stages:
            # index -1 reads the zero appended at the end
            v = torch.cat([v, v.new_zeros(B, 1)], dim=1)
            v = v[:, idx].sum(dim=2)
        out = vals.new_zeros(B, self.num_segments)
        return out.index_copy_(1, self.out_seg, v)
