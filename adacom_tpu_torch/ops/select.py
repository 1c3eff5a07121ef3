"""Selection masks: the replacement for DuckDB SelectionVectors.

Port of adacom_tpu/ops/select.py. The reference materializes selection
vectors of matching row ids (src/common/types/selection_vector.hpp); here
filters produce boolean masks. XLA needs static shapes, so the JAX package
compacts with a cumsum-scatter into a same-capacity buffer; torch has
dynamic shapes, so compaction is a boolean index."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def compact(mask: torch.Tensor, arrays: Sequence[torch.Tensor]
            ) -> Tuple[int, List[torch.Tensor]]:
    """Stable-compact `arrays` (each the length of mask) to the rows where
    mask is set. Returns (count, compacted arrays)."""
    outs = [a[mask] for a in arrays]
    count = int(mask.sum()) if not outs else int(outs[0].shape[0])
    return count, outs


def tail_mask(n_pad: int, counts: torch.Tensor) -> torch.Tensor:
    """(n, n_pad) mask of the real rows of n padded segments, row r of
    segment s being real iff r < counts[s]."""
    i = torch.arange(n_pad, device=counts.device)
    return i.unsqueeze(0) < counts.reshape(-1, 1)
