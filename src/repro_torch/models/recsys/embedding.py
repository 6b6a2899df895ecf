"""The recsys embedding table (port of `repro.models.recsys.embedding`).

All fields share one concatenated table; field f's rows start at
``field_offsets(vocab_sizes)[f]``.  `lookup` is the single-hot gather (a
plain `index_select`, as the reference's `jnp.take` outside any kernel);
`embedding_bag` is the weighted multi-hot bag, kernel B6 on the card
(`kernels/ops.embedding_bag`), with float32 products and sums as the
reference's TPU path.  The reference's row-sharding (`maybe_shard`) has
no counterpart on one card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops


def field_offsets(vocab_sizes) -> np.ndarray:
    """Per-field row offsets into the concatenated table (int32)."""
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)


def total_rows(vocab_sizes) -> int:
    return int(np.sum(vocab_sizes))


def init_table(generator: torch.Generator | None, vocab_sizes, dim: int,
               dtype=torch.float32, scale: float = 0.01, *,
               device=None) -> torch.Tensor:
    """(total_rows, dim) ~ Normal(0, scale^2), drawn in float32 from
    ``generator`` on ``device`` (None: the card) and cast to ``dtype``;
    on the meta device only the shape and type."""
    device = resolve_device(device)
    shape = (total_rows(vocab_sizes), dim)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(scale).to(dtype)


def flat_ids(ids: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-field local ids (B, F) -> rows of the concatenated table
    (B, F), int32."""
    return ids.to(torch.int32) + offsets.to(device=ids.device,
                                            dtype=torch.int32)[None, :]


def lookup(table: torch.Tensor, ids: torch.Tensor,
           offsets: torch.Tensor) -> torch.Tensor:
    """Single-hot per-field lookup: ids (B, F) local indices -> (B, F, D)."""
    flat = flat_ids(ids, offsets).reshape(-1)
    return table.index_select(0, flat).reshape(*ids.shape, table.shape[-1])


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Weighted multi-hot bag: idx, weights (B, K) -> (B, D).  On a CUDA
    table this is kernel B6; on the CPU its plain version."""
    return ops.embedding_bag(table, idx.to(torch.int32),
                             weights.to(torch.float32), impl=impl)
