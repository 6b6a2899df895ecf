"""Plain torch versions of the hand-written kernels (the correctness
references), mirroring `repro.kernels.ref`: unpack to float32, matmul,
threshold, pack; the tiled variants add the output's per-tile occupancy.  The CPU path of `kernels/ops.py` runs these; on the card
only the comparisons in `chip_smoke.py` and the cuda-marked tests do."""
from __future__ import annotations

import torch

from repro_torch.core import bitset


def bitmm_ref(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor) -> torch.Tensor:
    """Boolean matmul over packed words: (M, K/32) x (K, N/32) -> (M, N/32).

    out[m] = OR over {j : lhs bit j set} of rhs[j]."""
    lhs = bitset.unpack_bits(lhs_packed).to(torch.float32)
    rhs = bitset.unpack_bits(rhs_packed).to(torch.float32)
    return bitset.pack_bits((lhs @ rhs) > 0)


def closure_update_ref(closure_packed: torch.Tensor, mask_packed: torch.Tensor,
                       rows_packed: torch.Tensor) -> torch.Tensor:
    """Rank-B closure update: out[w] = closure[w] | OR_{j: mask[w,j]} rows[j].

    closure (C, C/32), mask (C, B/32), rows (B, C/32) -> (C, C/32)."""
    return closure_packed | bitmm_ref(mask_packed, rows_packed)


def closure_delete_ref(r_packed: torch.Tensor, s_packed: torch.Tensor,
                       affected_packed: torch.Tensor) -> torch.Tensor:
    """One hop of the delete-repair masked scan:
    out[w] = affected[w] ? r[w] | OR_{x: r[w,x]} s[x] : r[w].

    r, s (C, C/32); affected_packed (C/32,) row mask -> (C, C/32)."""
    aff = bitset.unpack_bits(affected_packed)      # (C,)
    prod = bitmm_ref(r_packed, s_packed)
    return torch.where(aff[:, None], r_packed | prod, r_packed)


def tile_occupancy_ref(tiles_packed: torch.Tensor) -> torch.Tensor:
    """Per-32x32-tile occupancy of a packed bit matrix: (R, R/32) ->
    int32 (R/32, R/32) of 0/1 (tile (ti, tj) covers rows ti*32..+31 of
    word column tj)."""
    r, wr = tiles_packed.shape
    return torch.any(tiles_packed.reshape(r // 32, 32, wr) != 0,
                     dim=1).to(torch.int32)


def closure_update_tiled_ref(tiles_packed: torch.Tensor,
                             mask_packed: torch.Tensor,
                             rows_packed: torch.Tensor):
    """Tiled rank-B fold: the dense update on the region window plus the
    output's per-tile occupancy -> (tiles' (R, R/32), occ (R/32, R/32))."""
    out = closure_update_ref(tiles_packed, mask_packed, rows_packed)
    return out, tile_occupancy_ref(out)


def closure_delete_tiled_ref(r_packed: torch.Tensor, s_packed: torch.Tensor,
                             affected_packed: torch.Tensor):
    """Tiled delete-repair hop: the dense masked hop on the region window
    plus the output's per-tile occupancy -> (r' (R, R/32), occ)."""
    out = closure_delete_ref(r_packed, s_packed, affected_packed)
    return out, tile_occupancy_ref(out)
