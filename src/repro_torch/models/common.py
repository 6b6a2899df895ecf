"""Shared model building blocks, in torch: RMSNorm, RoPE, SwiGLU and the
dense initialiser (port of `repro.models.common`).

The reference's sharding helpers (`maybe_shard`, the pspec pruning) are
identities off a mesh; the port has no mesh yet (ROADMAP.md section A
item 11), so they are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta^(i / half) for the float32 exponents i / half, evaluated
    in float64 and rounded to float32: torch's float32 ``pow`` is an ulp
    off in some entries, and at position 2048 an ulp of a frequency moves
    the angle by ~1e-4."""
    half = d_head // 2
    e = torch.arange(half, dtype=torch.float32, device=device) / half
    return (1.0 / (theta ** e.to(torch.float64))).to(torch.float32)


def rope_tables(positions: torch.Tensor, d_head: int, theta: float):
    """(cos, sin), each float32 (B, T, 1, Dh/2), of the angles
    positions * `rope_freqs`.  The angle is float32, as the reference's;
    its cosine and sine are taken in float64 and rounded: torch's float32
    sin and cos on the CPU are off by up to 1.5e-4 at angles of thousands
    of radians (the positions of a long prompt), where XLA's are within
    an ulp."""
    freqs = rope_freqs(d_head, theta, positions.device)       # (half,)
    ang = (positions[..., None].to(torch.float32) * freqs).to(torch.float64)
    return (torch.cos(ang).to(torch.float32)[:, :, None, :],
            torch.sin(ang).to(torch.float32)[:, :, None, :])


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables=None) -> torch.Tensor:
    """x (B, T, H, Dh); positions (B, T) int.  NeoX-style half rotation,
    computed in float32.  ``tables``: `rope_tables` of ``positions``,
    when the caller shares them between q, k and the layers."""
    cos, sin = tables if tables is not None else rope_tables(
        positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return h @ w_down.to(x.dtype)


def dense_init(generator: torch.Generator | None, shape, in_axis: int = 0,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Normal(0, 1 / fan_in) drawn in float32 from ``generator`` on
    ``device``, then cast to ``dtype``.  On the meta device nothing is
    drawn (the generator is not used)."""
    scale = (1.0 / max(1, shape[in_axis])) ** 0.5
    device = torch.device("cpu" if device is None else device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)
