"""Launch wrapper of kernel B6, the weighted embedding bag
(`csrc/embbag.cu`; it replaces the TPU kernel
`repro/kernels/embbag.py::embbag`).

``embbag(table (R, D), idx (B, K), weights (B, K))`` -> out (B, D) in the
table's type, out[b] = sum_k w[b, k] * table[idx[b, k]] summed in float32
(a row of at most 16 bytes: the k loop split across lanes, then a fixed
shuffle tree; wider rows: in ascending k).  CUDA tensors on one device:
a contiguous table of float32 or bfloat16, contiguous int32 idx and
float32 weights (0 for padding); any B >= 0, K >= 1, D >= 1.  Indices in
[0, R) are the caller's contract, as in the reference: nothing here
reads them on the host.  It launches its kernel or raises; for B = 0 it returns the empty
output without a launch.  The plain version is `kernels/ref.embbag_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 2}
TABLE_DTYPES, WEIGHT_DTYPES = tuple(DTYPES), (torch.float32,)


def embbag(table: torch.Tensor, idx: torch.Tensor,
           weights: torch.Tensor) -> torch.Tensor:
    dev, ((_, d), (b, k), w_shape) = _build.check_operands(
        (table, "table", 2, TABLE_DTYPES), (idx, "idx", 2, _build.INT32),
        (weights, "weights", 2, WEIGHT_DTYPES))
    if w_shape != (b, k) or k < 1 or d < 1:
        raise ValueError(
            "embbag shapes must be table (R, D), idx and weights (B, K) with "
            f"K >= 1 and D >= 1; got {tuple(table.shape)}, "
            f"{(b, k)}, {tuple(w_shape)}")
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    if b == 0:
        return out
    _build.launch("embbag", "repro_embbag", dev, table.data_ptr(),
                  idx.data_ptr(), weights.data_ptr(), out.data_ptr(), b, k, d,
                  DTYPES[table.dtype])
    return out
