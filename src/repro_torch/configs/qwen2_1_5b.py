"""qwen2-1.5b [dense] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias [arXiv:2407.10671; hf].  The port's copy of
`repro.configs.qwen2_1_5b` (bf16 weights, RoPE theta 1e6)."""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2-1.5b"
FAMILY = "lm"

CFG = LMConfig(
    name=ARCH_ID,
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960,
    vocab=151936, qkv_bias=True, rope_theta=1_000_000.0,
    train_microbatch=2,
    shard_heads=False, shard_kv=False,
)
