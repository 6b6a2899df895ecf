"""Launch wrappers of kernels B2 and B4, the rank-B closure fold
(`csrc/closure_update.cu` with its two paths in `csrc/bitgemm.cuh`,
`csrc/closure_update_tiled.cu`; they replace the TPU kernels
`repro/kernels/closure_update.py::closure_update` and
`::closure_update_tiled`).

``closure_update(closure (C, C/32), mask (C, B/32), rows (B, C/32))``
-> ``closure | OR_{j: mask[w, j]} rows[j]`` in a new (C, C/32) tensor;
``closure_update_tiled`` computes the same on a tiles window (R, R/32)
and also returns ``occ`` (R/32, R/32), the output's per-32x32-tile
occupancy (0/1).  CUDA int32 words holding the uint32 bit pattern; each
launches its kernel or raises.  A B2 call is two launches, as B1's
(`kernels/bitmm.py`): a count of each 128-row block's set mask bits,
then the fold, each block on the path its count picks;
``closure_update_paths`` runs the second alone on a count the caller
fills.  The plain versions are `kernels/ref.closure_update_ref` and
`closure_update_tiled_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmm import ROWS_PER_BLOCK


def _update_operands(closure_packed, mask_packed, rows_packed, *extra):
    dev, ((c, w), (c2, wb), (b, w2), *shapes) = _build.check_operands(
        (closure_packed, "closure", 2, _build.INT32),
        (mask_packed, "mask", 2, _build.INT32),
        (rows_packed, "rows", 2, _build.INT32), *extra)
    if c2 != c or w2 != w or wb * 32 != b:
        raise ValueError(
            "closure_update shapes must be closure (C, W), mask (C, B/32), "
            f"rows (B, W); got {(c, w)}, {(c2, wb)}, {(b, w2)}")
    return dev, c, wb, w, shapes


def closure_update(closure_packed: torch.Tensor, mask_packed: torch.Tensor,
                   rows_packed: torch.Tensor) -> torch.Tensor:
    dev, c, wb, w, _ = _update_operands(closure_packed, mask_packed,
                                        rows_packed)
    out = torch.empty_like(closure_packed)
    if c and w:
        work = out.new_empty(((c + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK,))
        _build.launch("closure_update", "repro_closure_update", dev,
                      closure_packed.data_ptr(), mask_packed.data_ptr(),
                      rows_packed.data_ptr(), out.data_ptr(), work.data_ptr(),
                      c, wb, w)
    return out


def closure_update_paths(closure_packed: torch.Tensor,
                         mask_packed: torch.Tensor, rows_packed: torch.Tensor,
                         work: torch.Tensor) -> torch.Tensor:
    """B2's main launch alone on ``work`` (int32, one entry per 128 rows),
    as `kernels.bitmm.bitmm_paths`: for timing or checking one path."""
    dev, c, wb, w, (w_shape,) = _update_operands(
        closure_packed, mask_packed, rows_packed,
        (work, "work", 1, _build.INT32))
    blocks = (c + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK
    if w_shape != (blocks,):
        raise ValueError(f"closure_update_paths: work must hold {blocks} "
                         f"entries (ceil(C/128)), got {tuple(w_shape)}")
    out = torch.empty_like(closure_packed)
    if c and w:
        _build.launch("closure_update", "repro_closure_update_paths", dev,
                      closure_packed.data_ptr(), mask_packed.data_ptr(),
                      rows_packed.data_ptr(), out.data_ptr(), work.data_ptr(),
                      c, wb, w)
    return out


def closure_update_tiled(tiles_packed: torch.Tensor, mask_packed: torch.Tensor,
                         rows_packed: torch.Tensor):
    dev, ((r, w), (r2, wb), (b, w2)) = _build.check_operands(
        (tiles_packed, "tiles", 2, _build.INT32),
        (mask_packed, "mask", 2, _build.INT32),
        (rows_packed, "rows", 2, _build.INT32))
    if w * 32 != r or r2 != r or w2 != w or wb * 32 != b:
        raise ValueError(
            "closure_update_tiled shapes must be tiles (R, R/32), mask "
            f"(R, B/32), rows (B, R/32); got {(r, w)}, {(r2, wb)}, "
            f"{(b, w2)}")
    out, occ = torch.empty_like(tiles_packed), tiles_packed.new_empty((w, w))
    if r:
        _build.launch("closure_update_tiled", "repro_closure_update_tiled",
                      dev, tiles_packed.data_ptr(), mask_packed.data_ptr(),
                      rows_packed.data_ptr(), out.data_ptr(), occ.data_ptr(),
                      r, wb, w)
    return out, occ
