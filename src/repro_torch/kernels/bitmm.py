"""Launch wrapper of kernel B1, the packed boolean product
(`csrc/bitmm.cu`; replaces the TPU kernel `repro/kernels/bitmm.py::bitmm`).

``bitmm(lhs (M, K/32), rhs (K, N/32)) -> (M, N/32)`` on CUDA int32 words
holding the uint32 bit pattern: out[m] = OR over set bits j of lhs[m] of
rhs[j].  It launches the kernel or raises; the plain version is
`kernels/ref.bitmm_ref`, and `kernels/ops.bitmm_packed` chooses."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def bitmm(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor) -> torch.Tensor:
    dev, ((m, wk), (k, wn)) = _build.check_operands(
        (lhs_packed, "lhs", 2, _build.INT32),
        (rhs_packed, "rhs", 2, _build.INT32))
    if wk * 32 != k:
        raise ValueError(f"lhs has {wk} words per row, so rhs needs "
                         f"{wk * 32} rows, got {(k, wn)}")
    out = torch.empty((m, wn), dtype=torch.int32, device=dev)
    if m and wn:
        _build.launch("bitmm", "repro_bitmm", dev, lhs_packed.data_ptr(),
                      rhs_packed.data_ptr(), out.data_ptr(), m, wk, wn)
    return out
