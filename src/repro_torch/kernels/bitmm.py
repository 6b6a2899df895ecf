"""Launch wrapper of kernel B1, the packed boolean product
(`csrc/bitmm.cu`, its two paths in `csrc/bitgemm.cuh`; replaces the TPU
kernel `repro/kernels/bitmm.py::bitmm`).

``bitmm(lhs (M, K/32), rhs (K, N/32)) -> (M, N/32)`` on CUDA int32 words
holding the uint32 bit pattern: out[m] = OR over set bits j of lhs[m] of
rhs[j].  It launches the kernel or raises; the plain version is
`kernels/ref.bitmm_ref`, and `kernels/ops.bitmm_packed` chooses.  A call
is two launches: the first counts the set bits of each block of 128 lhs
rows into a scratch array, the second takes each block down the sparse
(gathers) or the dense (int8 tensor cores) path by that count.
``bitmm_paths`` runs the second launch alone on a count the caller
fills, which times one path at a given shape (``chip_smoke.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

ROWS_PER_BLOCK = 128   # bitgemm::kRows: lhs rows a work entry counts


def _operands(lhs_packed, rhs_packed):
    dev, ((m, wk), (k, wn)) = _build.check_operands(
        (lhs_packed, "lhs", 2, _build.INT32),
        (rhs_packed, "rhs", 2, _build.INT32))
    if wk * 32 != k:
        raise ValueError(f"lhs has {wk} words per row, so rhs needs "
                         f"{wk * 32} rows, got {(k, wn)}")
    return dev, m, wk, wn


def bitmm(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor) -> torch.Tensor:
    dev, m, wk, wn = _operands(lhs_packed, rhs_packed)
    out = torch.empty((m, wn), dtype=torch.int32, device=dev)
    if m and wn:
        work = out.new_empty(((m + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK,))
        _build.launch("bitmm", "repro_bitmm", dev, lhs_packed.data_ptr(),
                      rhs_packed.data_ptr(), out.data_ptr(), work.data_ptr(),
                      m, wk, wn)
    return out


def bitmm_paths(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor,
                work: torch.Tensor) -> torch.Tensor:
    """B1's main launch on ``work`` (int32, one entry per 128 lhs rows): a
    block above the threshold (`dense_per_mille`) takes the dense path,
    any other the sparse one."""
    dev, m, wk, wn = _operands(lhs_packed, rhs_packed)
    blocks = (m + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK
    _build.check_operands((work, "work", 1, _build.INT32))
    if work.shape[0] != blocks or work.get_device() != dev:
        raise ValueError(f"work must hold {blocks} entries on the operands' "
                         f"card, got {tuple(work.shape)} on {work.device}")
    out = torch.empty((m, wn), dtype=torch.int32, device=dev)
    if m and wn:
        _build.launch("bitmm", "repro_bitmm_paths", dev,
                      lhs_packed.data_ptr(), rhs_packed.data_ptr(),
                      out.data_ptr(), work.data_ptr(), m, wk, wn)
    return out


def dense_per_mille() -> int:
    """The compiled threshold: a block of 128 lhs rows takes the dense
    path when its set bits exceed this share (per mille) of its 128 x K
    cells."""
    return _build.library().repro_bitgemm_dense_per_mille()
