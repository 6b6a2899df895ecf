"""Launch wrapper of kernel B7, GQA causal flash attention, forward
(`csrc/flash_attention.cu`; it replaces the TPU kernel
`repro/kernels/flashattn.py::flash_attention`).

``flash_attention(q (B, Hq, Tq, d), k (B, Hkv, Tk, d), v (B, Hkv, Tk, d))``
-> o (B, Hq, Tq, d) in q's type, float32 inside; causal is aligned to the
end of the key sequence.  The tensors may be strided views (the model
passes its (B, T, H, d) activations transposed, without a copy) as long
as the last dimension is contiguous and every stride and the data
pointer are 16-byte aligned.  The output has q's strides.  CUDA tensors
of one type (bfloat16, float16 or float32), d in {16, 32, 64, 128}; it
launches its kernel or raises.  The plain version is
`kernels/ref.flash_attention_ref`."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GRID_Y = 65535


def _check(t: torch.Tensor, name: str, index: int | None,
           dtype: torch.dtype) -> int:
    """Raise unless ``t`` is a (B, H, T, d) CUDA tensor of ``dtype`` on
    card ``index`` (any card when None) with a contiguous last dimension
    and 16-byte aligned strides and data; returns its card's index."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the kernel, got "
                         f"device {t.device}")
    at = t.get_device()
    if index is not None and at != index:
        raise ValueError(f"{name} is on {t.device}, expected "
                         f"{torch.device('cuda', index)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype} like q")
    if t.dim() != 4:
        raise ValueError(f"{name} must be (B, H, T, d), got "
                         f"{tuple(t.shape)}")
    step, strides = 16 // t.element_size(), t.stride()
    if strides[3] != 1 or any(s % step for s in strides[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} must have a contiguous last dimension and "
                         f"16-byte aligned strides and data, got strides "
                         f"{strides}")
    return at


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    dev = _check(q, "q", None, q.dtype)
    _check(k, "k", dev, q.dtype)
    _check(v, "v", dev, q.dtype)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {list(DTYPES)}, got "
                        f"{q.dtype}")
    b, hq, tq, d = q.shape
    bk, hkv, tk, dk = k.shape
    if k.shape != v.shape or bk != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(
            "flash_attention shapes must be q (B, Hq, Tq, d), k and v "
            f"(B, Hkv, Tk, d) with Hq % Hkv == 0; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes d in {HEAD_DIMS}, got {d}")
    if b * hq > MAX_GRID_Y:
        raise ValueError(f"B * Hq = {b * hq} exceeds {MAX_GRID_Y}")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)   # q's strides: q is dense and non-overlapping
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    _build.launch("flash_attention", "repro_flash_attention", dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                  hq, hkv, tq, tk, d, DTYPES[q.dtype], int(causal),
                  float(scale), strides)
    return out
