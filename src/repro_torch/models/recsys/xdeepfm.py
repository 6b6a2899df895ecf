"""xDeepFM (Lian et al., arXiv:1803.05170): linear + CIN + DNN, in torch
(port of `repro.models.recsys.xdeepfm`).

CIN layer: X^{k+1}[b,h,d] = sum_{i,j} W^k[h,i,j] X^k[b,i,d] X^0[b,j,d]
(outer product along fields, compressed by a learned kernel), sum-pooled
over the embedding dim into the final logit.

The linear term is a weighted embedding bag over the concatenated linear
table (K = the fields, unit weights, D = 1), so on the card it runs as
kernel B6; the reference sums a single-hot lookup of the same rows, the
same function.  A two-tower retrieval head (user tower from the
embeddings, item table) serves the ``retrieval_cand`` shape: one query
scored against 10^6 candidates as one matvec.

Params keep the reference's tree: {"table", "linear_table", "cin" (list),
"cin_out", "dnn" (list of (w, b)), "bias", "user_proj" (list of (w, b)),
"item_table"}.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engine import resolve_device
from repro_torch.models.gnn.graphs import mlp, mlp_init
from repro_torch.models.recsys import embedding as emb


@dataclass(frozen=True)
class XDeepFMConfig:
    name: str
    n_fields: int = 39
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp_dims: Tuple[int, ...] = (400, 400)
    vocab_sizes: Tuple[int, ...] = ()     # per-field; set by configs/
    n_items: int = 1_000_000              # retrieval candidate table
    retrieval_dim: int = 64
    dtype: Any = torch.float32

    def total_rows(self) -> int:
        return int(np.sum(self.vocab_sizes))


def default_vocab_sizes(n_fields: int, total: int = 20_000_000,
                        row_multiple: int = 2048):
    """Criteo-like power-law field vocabularies summing to ~total, the
    total padded to ``row_multiple`` (the reference's, number for
    number)."""
    raw = np.logspace(1.5, np.log10(total / 3), n_fields)
    raw = raw / raw.sum() * total
    sizes = [int(max(4, v)) for v in raw]
    tot = sum(sizes)
    sizes[-1] += (-tot) % row_multiple
    return tuple(sizes)


def _normal(generator, shape, scale: float, device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(scale)


def init_params(cfg: XDeepFMConfig, generator: torch.Generator | None = None,
                *, device=None):
    """Random params on ``device`` (None: the card) drawn from
    ``generator`` (None: one on ``device`` seeded with 0), with the
    reference's shapes, types and scales; on ``torch.device("meta")``
    only shapes and types."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    f, d = cfg.n_fields, cfg.embed_dim
    cin_ws = []
    h_prev = f
    for h in cfg.cin_layers:
        cin_ws.append(_normal(generator, (h, h_prev, f),
                              (1.0 / (h_prev * f)) ** 0.5, device))
        h_prev = h
    sum_h = sum(cfg.cin_layers)
    return {
        "table": emb.init_table(generator, cfg.vocab_sizes, d, cfg.dtype,
                                device=device),
        "linear_table": emb.init_table(generator, cfg.vocab_sizes, 1,
                                       torch.float32, device=device),
        "cin": cin_ws,
        "cin_out": _normal(generator, (sum_h, 1), (1.0 / sum_h) ** 0.5,
                           device),
        "dnn": mlp_init(generator, [f * d, *cfg.mlp_dims, 1], device=device),
        "bias": torch.zeros((1,), dtype=torch.float32, device=device),
        "user_proj": mlp_init(generator, [f * d, cfg.retrieval_dim],
                              device=device),
        "item_table": _normal(generator, (cfg.n_items, cfg.retrieval_dim),
                              0.01, device),
    }


def _offsets(cfg: XDeepFMConfig, device) -> torch.Tensor:
    return torch.from_numpy(emb.field_offsets(cfg.vocab_sizes)).to(device)


def _cin(x0: torch.Tensor, ws, w_out: torch.Tensor) -> torch.Tensor:
    """x0 (B, F, D) -> (B, 1) CIN logit."""
    xk = x0
    pools = []
    for w in ws:
        xk = torch.einsum("bid,bjd,hij->bhd", xk, x0, w.to(x0.dtype))
        pools.append(xk.sum(-1))                     # (B, H_k)
    p = torch.cat(pools, dim=-1)
    return p @ w_out.to(p.dtype)


def linear_term(params, ids: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """sum_f linear_table[ids[:, f] + offsets[f]] -> (B,), as one bag per
    sample over its fields with unit weights (kernel B6 on the card)."""
    idx = emb.flat_ids(ids, offsets)
    ones = torch.ones(idx.shape, dtype=torch.float32, device=ids.device)
    return emb.embedding_bag(params["linear_table"], idx, ones)[:, 0]


def forward(cfg: XDeepFMConfig, params, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F) per-field local indices -> logit (B,) float32."""
    offsets = _offsets(cfg, ids.device)
    e = emb.lookup(params["table"], ids, offsets).to(cfg.dtype)  # (B, F, D)
    lin = linear_term(params, ids, offsets)
    cin = _cin(e, params["cin"], params["cin_out"])[:, 0]
    dnn = mlp(e.reshape(e.shape[0], -1), params["dnn"], act=F.relu)[:, 0]
    return (lin.to(torch.float32) + cin.to(torch.float32)
            + dnn.to(torch.float32) + params["bias"][0])


def loss(cfg: XDeepFMConfig, params, batch) -> torch.Tensor:
    """Mean binary cross-entropy with logits of ``batch["ids"]`` against
    ``batch["labels"]`` (0/1), in its numerically stable form."""
    logit = forward(cfg, params, batch["ids"])
    y = batch["labels"].to(torch.float32)
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))


def retrieval_score(cfg: XDeepFMConfig, params, ids: torch.Tensor,
                    cand_ids: torch.Tensor) -> torch.Tensor:
    """One query (1, F) against candidates (Ncand,) -> scores (Ncand,)
    float32: the user tower's vector against the gathered item rows."""
    e = emb.lookup(params["table"], ids,
                   _offsets(cfg, ids.device)).to(cfg.dtype)
    user = mlp(e.reshape(e.shape[0], -1), params["user_proj"])   # (1, R)
    cand = params["item_table"].index_select(0, cand_ids)       # (Ncand, R)
    return (cand @ user[0].to(cand.dtype)).to(torch.float32)
