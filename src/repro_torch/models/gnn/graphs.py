"""Graph-model helpers (port of part of `repro.models.gnn.graphs`): the
MLP as a list of (w, b) pairs, which xDeepFM's DNN and user tower use.
The message-passing helpers wait for the GNN slice (ROADMAP.md section
A item 12c)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.engine import resolve_device


def mlp(x: torch.Tensor, ws, act=F.silu) -> torch.Tensor:
    """ws: list of (w, b); ``act`` (in float32) between layers, none after
    the last."""
    for i, (w, b) in enumerate(ws):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < len(ws) - 1:
            x = act(x.to(torch.float32)).to(x.dtype)
    return x


def mlp_init(generator: torch.Generator | None, dims, dtype=torch.float32,
             device=None):
    """[(w (dims[i], dims[i+1]) ~ Normal(0, 1 / dims[i]), b zeros)] on
    ``device`` (None: the card), drawn in float32 from ``generator`` and
    cast to ``dtype``; on the meta device only shapes and types."""
    device = resolve_device(device)
    ws = []
    for i in range(len(dims) - 1):
        shape = (dims[i], dims[i + 1])
        if device.type == "meta":
            w = torch.empty(shape, dtype=dtype, device=device)
        else:
            w = (torch.randn(shape, generator=generator, dtype=torch.float32,
                             device=device) * (1.0 / dims[i]) ** 0.5
                 ).to(dtype)
        ws.append((w, torch.zeros((dims[i + 1],), dtype=dtype,
                                  device=device)))
    return ws
