"""Decoder-only LM, dense, in torch: GQA + RoPE + RMSNorm + SwiGLU with
KV-cache prefill and greedy-decode steps (port of the serving half of
`repro.models.transformer`).

Params are a dict with the reference's tree: ``embed`` (padded vocab,
d), ``unembed`` (d, padded vocab), ``final_norm`` (d,) and ``layers``, a
dict of stacked leaves with a leading axis of size ``n_layers``; the
reference's ``scan`` over layers is a loop over that axis.  The prefill
attention always goes through `kernels.ops.flash_attention`: kernel B7
for CUDA tensors, its plain version for CPU tensors (``use_pallas`` gates
nothing here).  MoE, sequence parallelism and the sharding plans are not
ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models.common import (apply_rope, dense_init, rms_norm,
                                       rope_tables, swiglu)

MOE_NOT_PORTED = ("MoE layers are not ported yet (ROADMAP.md section A "
                  "item 12)")
SHARDING_NOT_PORTED = ("sequence parallelism and sharding plans are not "
                       "ported yet (ROADMAP.md section A item 11)")


@dataclass(frozen=True)
class LMConfig:
    """The reference's `LMConfig`, field for field, so configs copy over
    1:1.  The serving path reads the model's shape fields, ``qkv_bias``,
    ``rope_theta``, ``norm_eps`` and ``dtype``; ``moe`` and the sequence
    parallel and sharding fields raise unless off; the training and
    chunking fields are carried for the slices that will read them."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    moe: Optional[Any] = None
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    use_pallas: bool = False
    flash_custom_vjp: bool = True
    train_microbatch: int = 1
    attn_seq_parallel: bool = False
    sp_degree: int = 16
    moe_fsdp: bool = True
    moe_dispatch: str = "einsum"
    full_sp: bool = False
    shard_heads: bool = False
    shard_kv: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 (the reference pads it so the unembed
        shards evenly); padded logit columns are masked to -1e30."""
        return ((self.vocab + 255) // 256) * 256

    def param_count(self) -> int:
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads + 2 * self.n_kv) * dh + self.n_heads * dh * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv) * dh
        if self.moe is not None:
            ffn = d * self.moe.n_experts + \
                3 * self.moe.n_experts * d * self.moe.d_ff
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads + 2 * self.n_kv) * dh + self.n_heads * dh * d
        ffn = d * self.moe.n_experts + 3 * self.moe.top_k * d * self.moe.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


def _check_ported(cfg: LMConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(MOE_NOT_PORTED)
    if cfg.attn_seq_parallel or cfg.full_sp or cfg.shard_heads \
            or cfg.shard_kv:
        raise NotImplementedError(SHARDING_NOT_PORTED)


# ------------------------------------------------------------------ params

def _layer_defs(cfg: LMConfig):
    """(name, shape without the layer axis, fan-in axis or None) of the
    stacked layer params, in the reference's order."""
    _check_ported(cfg)
    d, dh = cfg.d_model, cfg.d_head
    defs = [
        ("ln1", (d,), None),
        ("ln2", (d,), None),
        ("wq", (d, cfg.n_heads * dh), 0),
        ("wk", (d, cfg.n_kv * dh), 0),
        ("wv", (d, cfg.n_kv * dh), 0),
        ("wo", (cfg.n_heads * dh, d), 0),
    ]
    if cfg.qkv_bias:
        defs += [
            ("bq", (cfg.n_heads * dh,), None),
            ("bk", (cfg.n_kv * dh,), None),
            ("bv", (cfg.n_kv * dh,), None),
        ]
    defs += [
        ("w_gate", (d, cfg.d_ff), 0),
        ("w_up", (d, cfg.d_ff), 0),
        ("w_down", (cfg.d_ff, d), 0),
    ]
    return defs


def init_params(cfg: LMConfig, generator: torch.Generator | None = None, *,
                device=None) -> Dict:
    """Random params on ``device`` (None: the card; raises without one)
    drawn from ``generator`` (None: one on ``device`` seeded with 0):
    norms 1, biases 0, matrices Normal(0, 1 / fan_in) in ``cfg.dtype``.
    On ``torch.device("meta")`` only the shapes and types are made."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    layers = {}
    for name, shape, fan_axis in _layer_defs(cfg):
        full = (cfg.n_layers, *shape)
        if name.startswith("ln"):
            layers[name] = torch.ones(full, dtype=torch.float32,
                                      device=device)
        elif fan_axis is None:  # bias
            layers[name] = torch.zeros(full, dtype=cfg.dtype, device=device)
        else:
            layers[name] = dense_init(generator, full, in_axis=fan_axis + 1,
                                      dtype=cfg.dtype, device=device)
    return {
        "embed": dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                            in_axis=1, dtype=cfg.dtype, device=device),
        "unembed": dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                              in_axis=0, dtype=cfg.dtype, device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=device),
        "layers": layers,
    }


def _mask_padded_vocab(cfg: LMConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= cfg.vocab, -1e30)


# ----------------------------------------------------------------- forward

def _qkv(cfg: LMConfig, h: torch.Tensor, lp: Dict, positions: torch.Tensor,
         rope=None):
    """Projected, biased and rotated q (B, T, Hq, dh), k and v
    (B, T, Hkv, dh) of the normed input ``h``; ``rope`` is the positions'
    `rope_tables`, made once per call and shared by the layers."""
    b, t, _ = h.shape
    q = h @ lp["wq"].to(h.dtype)
    k = h @ lp["wk"].to(h.dtype)
    v = h @ lp["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    q = q.reshape(b, t, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, t, cfg.n_kv, cfg.d_head)
    v = v.reshape(b, t, cfg.n_kv, cfg.d_head)
    return (apply_rope(q, positions, cfg.rope_theta, rope),
            apply_rope(k, positions, cfg.rope_theta, rope), v)


def _attn_block(cfg: LMConfig, x: torch.Tensor, lp: Dict,
                positions: torch.Tensor, rope=None):
    """Returns (attn_out (B, T, d), (k, v) of this layer).  The attention
    takes (B, H, T, dh): the transposes are views, not copies."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), lp, positions,
                   rope)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True).transpose(1, 2)
    o = o.reshape(b, t, cfg.n_heads * cfg.d_head)
    return o @ lp["wo"].to(o.dtype), (k, v)


def _ffn_block(cfg: LMConfig, x: torch.Tensor, lp: Dict) -> torch.Tensor:
    """The dense FFN's output (B, T, d)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _layer(cfg: LMConfig, x: torch.Tensor, lp: Dict,
           positions: torch.Tensor, rope=None):
    attn, kv = _attn_block(cfg, x, lp, positions, rope)
    x = x + attn
    return x + _ffn_block(cfg, x, lp), kv


def _layer_params(params: Dict, i: int) -> Dict:
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def _trunk(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
           positions: Optional[torch.Tensor], cache_len: Optional[int]):
    """The layers and the final norm -> (x (B, T, d), cache or None);
    with ``cache_len`` each layer's k and v are written into a zero cache
    {"k", "v"} of (L, B, cache_len, Hkv, dh)."""
    _check_ported(cfg)
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=tokens.device).expand(b, t)
    x = params["embed"][tokens].to(cfg.dtype)
    cache = None
    if cache_len is not None:
        shape = (cfg.n_layers, b, cache_len, cfg.n_kv, cfg.d_head)
        cache = {name: torch.zeros(shape, dtype=cfg.dtype, device=x.device)
                 for name in ("k", "v")}
    rope = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x, (k, v) = _layer(cfg, x, _layer_params(params, i), positions, rope)
        if cache is not None:
            cache["k"][i, :, :t] = k
            cache["v"][i, :, :t] = v
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def _unembed(cfg: LMConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    return _mask_padded_vocab(cfg, x @ params["unembed"].to(x.dtype))


def forward(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            return_cache: bool = False):
    """tokens (B, T) -> (logits (B, T, padded vocab), aux) or, with
    ``return_cache``, (logits, cache {"k", "v"}: (L, B, T, Hkv, dh),
    aux).  aux is the reference's MoE load-balance loss: 0 for the dense
    FFN, the only one ported."""
    x, cache = _trunk(cfg, params, tokens, positions,
                      tokens.shape[1] if return_cache else None)
    logits = _unembed(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (logits, cache, aux) if return_cache else (logits, aux)


def prefill(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            max_len: int):
    """Run the prompt, returning the last token's logits (B, padded
    vocab) and a cache padded with zeros to ``max_len`` along the
    sequence dim.  Only the last position is unembedded: the reference
    unembeds every position and returns the last, which is the same
    number (per position, the final norm and the unembed do not mix
    positions)."""
    x, cache = _trunk(cfg, params, tokens, None, max_len)
    return _unembed(cfg, params, x[:, -1]), cache


def decode_step(cfg: LMConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, pos):
    """One decode step.  tokens (B,) int; pos an int (aligned batch).

    cache {"k", "v"}: (L, B, S, Hkv, dh).  Each layer's new k and v are
    written into the cache at ``pos`` IN PLACE before it attends (the
    reference returns a new cache; updating in place saves copying the
    whole cache every token).  Returns (logits (B, padded vocab), the
    cache)."""
    _check_ported(cfg)
    pos = int(pos)
    b = tokens.shape[0]
    x = params["embed"][tokens][:, None, :].to(cfg.dtype)
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    rope = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        bsz, t, _ = x.shape
        q, k, v = _qkv(cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), lp,
                       positions, rope)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, pos:pos + 1] = k
        vc[:, pos:pos + 1] = v
        o = attention.decode_attention(q, kc, vc, cache_len=pos + 1)
        o = o.reshape(bsz, t, cfg.n_heads * cfg.d_head)
        x = x + o @ lp["wo"].to(o.dtype)
        x = x + _ffn_block(cfg, x, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, x)[:, 0], cache
