"""Launch wrappers of kernels B2 and B4, the rank-B closure fold
(`csrc/closure_update.cu`, `csrc/closure_update_tiled.cu`; they replace
the TPU kernels `repro/kernels/closure_update.py::closure_update` and
`::closure_update_tiled`).

``closure_update(closure (C, C/32), mask (C, B/32), rows (B, C/32))``
-> ``closure | OR_{j: mask[w, j]} rows[j]`` in a new (C, C/32) tensor;
``closure_update_tiled`` computes the same on a tiles window (R, R/32)
and also returns ``occ`` (R/32, R/32), the output's per-32x32-tile
occupancy (0/1).  CUDA int32 words holding the uint32 bit pattern; each
launches its kernel or raises.  The plain versions are
`kernels/ref.closure_update_ref` and `closure_update_tiled_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def closure_update(closure_packed: torch.Tensor, mask_packed: torch.Tensor,
                   rows_packed: torch.Tensor) -> torch.Tensor:
    dev = closure_packed.device
    _build.check_operand(closure_packed, "closure", 2)
    _build.check_operand(mask_packed, "mask", 2, dev)
    _build.check_operand(rows_packed, "rows", 2, dev)
    c, w = closure_packed.shape
    c2, wb = mask_packed.shape
    b, w2 = rows_packed.shape
    if c2 != c or w2 != w or wb * 32 != b:
        raise ValueError(
            "closure_update shapes must be closure (C, W), mask (C, B/32), "
            f"rows (B, W); got {tuple(closure_packed.shape)}, "
            f"{tuple(mask_packed.shape)}, {tuple(rows_packed.shape)}")
    out = torch.empty_like(closure_packed)
    if out.numel():
        _build.launch("closure_update", "repro_closure_update", dev,
                      closure_packed, mask_packed, rows_packed, out, c, wb, w)
    return out


def closure_update_tiled(tiles_packed: torch.Tensor, mask_packed: torch.Tensor,
                         rows_packed: torch.Tensor):
    dev = tiles_packed.device
    _build.check_operand(tiles_packed, "tiles", 2)
    _build.check_operand(mask_packed, "mask", 2, dev)
    _build.check_operand(rows_packed, "rows", 2, dev)
    r, w = tiles_packed.shape
    r2, wb = mask_packed.shape
    b, w2 = rows_packed.shape
    if w * 32 != r or r2 != r or w2 != w or wb * 32 != b:
        raise ValueError(
            "closure_update_tiled shapes must be tiles (R, R/32), mask "
            f"(R, B/32), rows (B, R/32); got {tuple(tiles_packed.shape)}, "
            f"{tuple(mask_packed.shape)}, {tuple(rows_packed.shape)}")
    out = torch.empty_like(tiles_packed)
    occ = torch.empty((r // 32, w), dtype=torch.int32, device=dev)
    if out.numel():
        _build.launch("closure_update_tiled", "repro_closure_update_tiled",
                      dev, tiles_packed, mask_packed, rows_packed, out, occ,
                      r, wb, w)
    return out, occ
