"""Plain torch versions of the hand-written kernels (the correctness
references), mirroring `repro.kernels.ref`: the bit kernels unpack to
float32, matmul, threshold and pack, and the tiled variants add the
output's per-tile occupancy; attention is a float32 softmax over the
whole score matrix.  The CPU path of `kernels/ops.py` runs these; on the
card only the comparisons in `chip_smoke.py` and the cuda-marked tests
do."""
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """GQA attention: q (B, Hq, Tq, d), k and v (B, Hkv, Tk, d) with
    Hq % Hkv == 0 -> (B, Hq, Tq, d) in q's type, computed in float32.
    Causal queries sit at the END of the key sequence (query i sees keys
    j <= i + Tk - Tq).

    A masked score contributes exactly 0, and a query row that sees no key
    (causal with Tq > Tk) gives 0, as kernel B7 does.  There the reference
    `repro.kernels.ref.flash_attention_ref` gives NaN (its mask is -inf)
    and the Pallas kernel gives the mean of v (its finite NEG_INF makes
    every masked exp(s - m) 1); every row that sees a key agrees with
    both."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.to(torch.float32).reshape(b, hkv, g, tq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.to(torch.float32)) * scale
    if causal:
        qpos = torch.arange(tq, device=q.device) + (tk - tq)
        kpos = torch.arange(tk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / torch.where(den == 0, 1.0, den),
                     v.to(torch.float32))
    return o.reshape(b, hq, tq, d).to(q.dtype)
