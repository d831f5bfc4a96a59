"""Ordered row scatter-add: the reference's ``table.at[idx].add(rows)``.

Repeated indices must SUM (``t[idx] += v`` keeps one of them), and on the
card the sum must not depend on the run: CUDA's ``index_add_`` adds with
atomics, whose f32 order changes from launch to launch.  ``add_rows``
therefore takes ``index_add_`` on the CPU (a serial loop over the
indices) and ``index_put_(accumulate=True)`` on the card, whose
sort-based path sorts the indices stably and lets one warp add a row's
duplicates in index order — bitwise the CPU's serial sums for rows of
more than 32 elements.  A 1-D table takes CUDA's stride-1 kernel, which
adds an entry's duplicates in another order that is fixed from run to
run.  The word2vec family, GloVe and the chunked t-SNE use it.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def add_rows(table: Tensor, idx: Tensor, rows: Tensor) -> Tensor:
    """``table[idx] += rows`` in place, repeated indices summed in index
    order; returns ``table``."""
    if table.is_cuda:
        table.index_put_((idx,), rows, accumulate=True)
    else:
        table.index_add_(0, idx, rows)
    return table
