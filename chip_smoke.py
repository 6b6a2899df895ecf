"""Smoke run of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py

Phases, one status line each; the first failure raises and exits
non-zero:
  1. device     — the card's name and power limit (no card: exit 2).
  2. build      — nvcc builds kernels B1-B5 and B7 from
                  src/repro_torch/csrc; registers and shared memory per
                  kernel (-Xptxas -v).
  3. kernels    — every kernel bit-identical to its plain torch version
                  at the shapes and densities of tests/test_kernels.py
                  (B1-B3) and over windows R in {32, 96, 1024, 4096},
                  densities 0 / 1% / 25% / 100%, all-live and no-live
                  bands (B4, B5, occupancy included), and at the main
                  paths' shapes (C=16384, B=1024 dense; R=1024, B=128
                  tiled), with CUDA event times of the kernel, the plain
                  version and a library yardstick, beside the least time
                  the card could take (bound); kernel_ms is per call
                  (CUDA events), device_ms the kernel alone
                  (torch.profiler).  B7 (flash attention) against its
                  plain version in bf16, f16 and f32 at the LM main path's
                  shape (4, 12, 2048, 128) over 2 KV heads, a ragged T,
                  a decode-like Tq=1 / Tk=2080, Tq < Tk and Tq > Tk,
                  non-causal, and d = 64 and 16, every element within
                  its rounding bound (ATTN_TOL: bf16 2^-7 |want| +
                  2^-8 sum_j p_j |v_j|, f16 2^-10 and 2^-11, capped at
                  2e-2 / 4e-3; f32 1e-4);
                  the same bound must reject the main shape's output
                  with one 64-key tile left out; its library yardstick
                  is one scaled_dot_product_attention call.
  4. parity     — on the card (kernels) and on the CPU (plain versions),
                  compared after every call (ok bits, adjacency, closure
                  words or tiles and summary, dirty flag, epoch,
                  ReachStats): the delheavy and steady SGT streams at
                  C=2048, B=256, 8 ticks (dense), and the mixed churn
                  stream at C=2048, B=128, 8 ticks on the tiled layout
                  with the default window and a 64-slot one; and the LM
                  (qwen2-1.5b at smoke width, float32, TF32 off): the
                  prefill's last-token logits and KV cache within 1e-4
                  of the CPU's and identical greedy tokens over 8 decode
                  steps, from the same params and prompt.
  5. main path  — `repro_torch.launch.serve` at C=16384, B=1024 under the
                  CLI's default method ("auto"): steady (engine api) 10
                  ticks, delheavy 10 ticks, insheavy 6 ticks, each
                  followed by 1024 reachable() queries; then the tiled
                  layout's main path, `serve_sgt_churn` at C=131072,
                  B=128, 10 mixed ticks, method "incremental", default
                  window (1024 slots; the 2 GiB adjacency on the card).
                  Each run has its launch counters zeroed just before it
                  and read just after.  Checks: the C=131072 accept bits
                  equal a 64-slot-window run's on the same stream, and at
                  C=16384 the tiled layout's equal the dense layout's;
                  cache_matches_state and is_acyclic hold (the tiled
                  checks square the window once region_confined holds).
                  Fails unless every kernel of B1-B5 launched.
  6. lm         — the LM main path, `serve_lm` at full width
                  (qwen2-1.5b, bf16, batch 4, prompt 2048, 32 greedy
                  tokens) after a warm-up call, counters zeroed just
                  before it: prefill ms, decode ms per token, tokens/s,
                  peak memory, B7's launches (28, one per layer of the
                  prefill) and its share of a profiled prefill; a
                  profiled decode step (device busy, idle share); logits
                  finite, every token inside the vocab.
The line before the last is the per-kernel JSON record, the last line
the device record.  Imports only the port, torch and numpy.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12        # H100 SXM data sheet, dense int8 tensor
BF16_FLOP_PER_S = 989e12        # H100 SXM data sheet, dense bf16 tensor
C_FULL, B_FULL = 16384, 1024    # the dense layout's main path
C_TILED, B_TILED, T_TILED = 131072, 128, 10   # the tiled layout's main path
R_TILED = 1024                  # its window (closure_cache.DEFAULT_REGION)
C_PARITY, B_PARITY, T_PARITY = 2048, 256, 8
B_PARITY_TILED = 128
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen2-1.5b", 4, 2048, 32
LM_PARITY_BATCH, LM_PARITY_PROMPT, LM_PARITY_STEPS = 4, 64, 8
# B7 against its plain version, per element, as (out, prob, atol, cap):
# |got - want| <= min(out |want| + prob sum_j p_j |v_j| + atol, cap).
# Both compute in float32 from the same inputs.  Both round a bf16 / f16
# output to 8 / 11 significant bits: together at most one ulp, 2^-7 /
# 2^-10 of the value.  The kernel also rounds each probability p_j to
# that type before the P.V product, by at most half an ulp (2^-8 / 2^-11
# of p_j), which moves the sum by at most that share of sum_j p_j |v_j|.
# atol covers float32 summation order; cap is each type's absolute
# bound.
ATTN_TOL = {torch.bfloat16: (2 ** -7, 2 ** -8, 1e-6, 2e-2),
            torch.float16: (2 ** -10, 2 ** -11, 1e-6, 4e-3),
            torch.float32: (0.0, 0.0, 1e-4, 1e-4)}
BIT_KERNELS = ("bitmm", "closure_update", "closure_delete",
               "closure_update_tiled", "closure_delete_tiled")

KERNELS = {
    "bitmm": ("src/repro_torch/csrc/bitmm.cu", "src/repro/kernels/bitmm.py:50"),
    "closure_update": ("src/repro_torch/csrc/closure_update.cu",
                       "src/repro/kernels/closure_update.py:56"),
    "closure_delete": ("src/repro_torch/csrc/closure_delete.cu",
                       "src/repro/kernels/closure_delete.py:67"),
    "closure_update_tiled": ("src/repro_torch/csrc/closure_update_tiled.cu",
                             "src/repro/kernels/closure_update.py:120"),
    "closure_delete_tiled": ("src/repro_torch/csrc/closure_delete_tiled.cu",
                             "src/repro/kernels/closure_delete.py:134"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flashattn.py:66"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ------------------------------------------------------------- 1. device

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    say("device", f"{name}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    return smi.stdout.strip().splitlines()[0]


# -------------------------------------------------------------- 2. build

def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    say("build", f"{lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f}s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    kernel = None
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = next((k for k in KERNELS if f"{k}_kernel" in m.group(1)),
                          m.group(1))
            t = re.search(r"flash_attention_kernelI(\w+?)Li(\d+)E",
                          m.group(1))
            if t:   # one instantiation per (type, head dim)
                kernel = f"flash_attention<{t.group(1)}, d={t.group(2)}>"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            say("build", f"{kernel}: {m.group(1)} registers, "
                f"{smem.group(1) if smem else 0} bytes static shared memory")
        if "spill" in line and kernel:
            say("build", f"{kernel}: {line.strip()}")


# ------------------------------------------------------------ 3. kernels

def packed(shape, density, gen):
    from repro_torch.core import bitset
    return bitset.pack_bits(torch.rand(shape, generator=gen,
                                       device="cuda") < density)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds of the CUDA kernel named ``kernel`` per
    launch over ``reps`` calls of ``fn``, from `torch.profiler`: the
    kernel alone, without the host time of its wrapper (which sets the
    per-call time of a kernel shorter than its launch)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_ticks import _device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if f"{kernel}_kernel" in e.key]
    # the mean over the launches the profiler recorded (it may drop one)
    launches = sum(e.count for e in events)
    check(launches > 0, f"the profiler saw no launch of {kernel}")
    return sum(_device_us(e) for e in events) / 1e3 / launches


def mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference of the packed 0/1 entries."""
    return 1.0 if bool(torch.any(a != b)) else 0.0


def popcount_total(x: torch.Tensor) -> int:
    from repro_torch.core import bitset
    return int(torch.sum(bitset.popcount(x), dtype=torch.int64))


def bound(nbytes: int, ops: int, ops_per_s: float = INT8_OPS_PER_S):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth
    and the operations over the tensor-core peak ``ops_per_s`` (int8 for
    the bit kernels)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fp16_matmul_ms(lhs_packed, rhs_packed, reps: int) -> float:
    """The library yardstick: one fp16 torch.matmul of the unpacked
    operands (no packed boolean product exists as one PyTorch call)."""
    from repro_torch.core import bitset
    a = bitset.unpack_bits(lhs_packed).to(torch.float16)
    b = bitset.unpack_bits(rhs_packed).to(torch.float16)
    ms = cuda_ms(lambda: torch.matmul(a, b), reps)
    del a, b
    return ms


def phase_kernels():
    """Bit-identity sweeps plus timings; returns {kernel: record}."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {k: 0.0 for k in BIT_KERNELS}
    n_cases = 0
    for m, k, n in [(128, 128, 128), (64, 256, 512), (256, 512, 256),
                    (8, 1024, 1024), (33, 96, 160)]:
        for d in (0.0, 0.02, 0.5):
            lhs, rhs = packed((m, k), d, gen), packed((k, n), 0.05, gen)
            err["bitmm"] = max(err["bitmm"], mismatch(
                ops.bitmm_packed(lhs, rhs, impl="cuda"),
                ops.bitmm_packed(lhs, rhs, impl="ref")))
            n_cases += 1
    for c, b in [(128, 32), (256, 64), (512, 256), (1024, 32), (320, 64)]:
        for d in (0.0, 0.05, 0.5):
            args = (packed((c, c), d, gen), packed((c, b), 0.2, gen),
                    packed((b, c), 0.1, gen))
            err["closure_update"] = max(err["closure_update"], mismatch(
                ops.closure_update(*args, impl="cuda"),
                ops.closure_update(*args, impl="ref")))
            n_cases += 1
    for c in (128, 320, 512, 1024):
        for af in (0.0, 0.25, 1.0):
            args = (packed((c, c), 0.05, gen), packed((c, c), 0.05, gen),
                    packed((c,), af, gen))
            err["closure_delete"] = max(err["closure_delete"], mismatch(
                ops.closure_delete(*args, impl="cuda"),
                ops.closure_delete(*args, impl="ref")))
            n_cases += 1
    for r in (32, 96, 1024, 4096):
        for d in (0.0, 0.01, 0.25, 1.0):
            for band_live in (True, False):
                mask = packed((r, B_TILED), d, gen)
                aff = packed((r,), 1.0, gen)
                if not band_live:   # every other 32-row band carries nothing
                    mask.view(r // 32, 32, -1)[1::2] = 0
                    aff[1::2] = 0
                upd = (packed((r, r), d, gen), mask,
                       packed((B_TILED, r), d, gen))
                dele = (packed((r, r), d, gen), packed((r, r), d, gen), aff)
                for name, fn, args in (
                        ("closure_update_tiled", ops.closure_update_tiled,
                         upd),
                        ("closure_delete_tiled", ops.closure_delete_tiled,
                         dele)):
                    (out, occ), (want, want_occ) = (
                        fn(*args, impl="cuda"), fn(*args, impl="ref"))
                    err[name] = max(err[name], mismatch(out, want),
                                    mismatch(occ, want_occ))
                    n_cases += 1
    torch.cuda.synchronize()
    say("kernels", f"{n_cases} cases on the card (test_kernels.py shapes; "
        f"tiled windows 32-4096), max abs err per kernel {err}")
    check(not any(err.values()), f"kernel disagrees with its plain "
          f"version at the test shapes: {err}")

    records = {}
    c, w = C_FULL, C_FULL // 32
    say("kernels", "library_ms = one fp16 torch.matmul of the unpacked "
        "operands: a yardstick only, the port never calls it")

    def measure(name, label, kernel_fn, plain_fn, lib_args, nbytes, ops_n,
                reps=20, plain_reps=3, lib_reps=5):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if isinstance(got, tuple):   # the tiled kernels: (words, occ)
            e = max(mismatch(a, b) for a, b in zip(got, want))
        else:
            e = mismatch(got, want)
        del got, want
        check(e == 0.0, f"{name} disagrees with its plain version at {label}")
        rec = {"ms": cuda_ms(kernel_fn, reps),
               "plain_ms": cuda_ms(plain_fn, plain_reps),
               "library_ms": fp16_matmul_ms(*lib_args, lib_reps)}
        device = kernel_device_ms(kernel_fn, reps, name)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops_n)
        rec["max_abs_err"] = max(e, err[name])
        say("kernels", f"{name} {label}: kernel_ms={rec['ms']:.4f} "
            f"(device_ms={device:.4f} alone) plain_ms={rec['plain_ms']:.3f} "
            f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
            f"library_ms={rec['library_ms']:.3f}")
        return rec

    # B1: a closure squaring (C x C) and a frontier hop (B rows), 1% dense
    lhs, rhs = packed((c, c), 0.01, gen), packed((c, c), 0.01, gen)
    records["bitmm"] = measure(
        "bitmm", f"squaring ({c}, {w}) x ({c}, {w}), 1% dense",
        lambda: ops.bitmm_packed(lhs, rhs, impl="cuda"),
        lambda: ops.bitmm_packed(lhs, rhs, impl="ref"), (lhs, rhs),
        3 * c * w * 4, 2 * popcount_total(lhs) * c)
    front = packed((B_FULL, c), 0.01, gen)
    measure("bitmm", f"frontier hop ({B_FULL}, {w}) x ({c}, {w}), 1% dense",
            lambda: ops.bitmm_packed(front, rhs, impl="cuda"),
            lambda: ops.bitmm_packed(front, rhs, impl="ref"), (front, rhs),
            (2 * B_FULL * w + c * w) * 4, 2 * popcount_total(front) * c)
    del front
    # B2: the rank-B fold at C=16384, B=1024
    mask = packed((c, B_FULL), 0.01, gen)
    rows = packed((B_FULL, c), 0.01, gen)
    records["closure_update"] = measure(
        "closure_update", f"C={c} B={B_FULL}, 1% dense mask and rows",
        lambda: ops.closure_update(lhs, mask, rows, impl="cuda"),
        lambda: ops.closure_update(lhs, mask, rows, impl="ref"),
        (mask, rows), (2 * c * w + c * B_FULL // 32 + B_FULL * w) * 4,
        2 * popcount_total(mask) * c)
    del mask, rows
    # B3: one repair hop at C=16384, 1% and 25% of the rows affected
    from repro_torch.core import bitset
    for frac in (0.01, 0.25):
        aff = packed((c,), frac, gen)
        aff_rows = bitset.unpack_bits(aff)
        rec = measure(
            "closure_delete", f"C={c}, {frac:.0%} rows affected, 1% dense",
            lambda: ops.closure_delete(lhs, rhs, aff, impl="cuda"),
            lambda: ops.closure_delete(lhs, rhs, aff, impl="ref"),
            (lhs, rhs), (3 * c * w + w) * 4,
            2 * popcount_total(lhs[aff_rows]) * c)
        if frac == 0.01:
            records["closure_delete"] = rec
    del lhs, rhs
    # B4 and B5 at the tiled main path's window (R=1024) and batch
    # (B=128), operands 1% dense: bytes under 1 us, so launch latency
    # sets the time
    r, wr = R_TILED, R_TILED // 32
    tiles, s = packed((r, r), 0.01, gen), packed((r, r), 0.01, gen)
    mask = packed((r, B_TILED), 0.01, gen)
    rows = packed((B_TILED, r), 0.01, gen)
    records["closure_update_tiled"] = measure(
        "closure_update_tiled", f"R={r} B={B_TILED}, 1% dense",
        lambda: ops.closure_update_tiled(tiles, mask, rows, impl="cuda"),
        lambda: ops.closure_update_tiled(tiles, mask, rows, impl="ref"),
        (mask, rows), (2 * r * wr + r * B_TILED // 32 + B_TILED * wr
                       + (r // 32) * wr) * 4,
        2 * popcount_total(mask) * r, reps=200, plain_reps=20, lib_reps=50)
    for frac in (0.01, 0.25):
        aff = packed((r,), frac, gen)
        aff_rows = bitset.unpack_bits(aff)
        rec = measure(
            "closure_delete_tiled", f"R={r}, {frac:.0%} rows affected, "
            "1% dense",
            lambda: ops.closure_delete_tiled(tiles, s, aff, impl="cuda"),
            lambda: ops.closure_delete_tiled(tiles, s, aff, impl="ref"),
            (tiles, s), (3 * r * wr + wr + (r // 32) * wr) * 4,
            2 * popcount_total(tiles[aff_rows]) * r, reps=200,
            plain_reps=20, lib_reps=50)
        if frac == 0.01:
            records["closure_delete_tiled"] = rec
    del tiles, s, mask, rows
    records["flash_attention"] = flash_attention_records(gen)
    torch.cuda.empty_cache()
    return records


def causal_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: every pair, or causal
    with queries aligned to the end of the keys."""
    if not causal:
        return tq * tk
    off = tk - tq
    return sum(min(tk, max(0, i + off + 1)) for i in range(tq))


def attention_error(got, want, q, k, v, causal=True):
    """(max abs error, max of the error over its bound ATTN_TOL) of B7's
    output ``got`` against the plain version's ``want`` on q, k, v."""
    from repro_torch.kernels import ops

    out, prob, atol, cap = ATTN_TOL[want.dtype]
    w = want.float()
    err = (got.float() - w).abs()
    tol = out * w.abs() + atol
    if prob:        # sum_j p_j |v_j|: the plain version on |v|, in f32
        tol += prob * ops.flash_attention(q.float(), k.float(),
                                          v.float().abs(), causal=causal,
                                          impl="ref")
    return float(err.max()), float((err / tol.clamp(max=cap)).max())


def attention_without_keys(q, k, v, lo: int, hi: int):
    """The plain causal attention (Tq = Tk) with keys [lo, hi) left out
    of every row: what a kernel that skipped that KV tile would give."""
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.float().reshape(b, hkv, hq // hkv, t, d),
                     k.float()) / d ** 0.5
    pos = torch.arange(t, device=q.device)
    drop = (pos[None, :] > pos[:, None]) | ((pos >= lo) & (pos < hi))
    p = torch.softmax(s.masked_fill(drop, float("-inf")), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, t, d).to(q.dtype)


def flash_attention_records(gen):
    """B7 against its plain version over the sweep, then its timings at
    the LM main path's prefill shape; returns its record."""
    from repro_torch.kernels import ops

    def qkv(b, hq, hkv, tq, tk, d, dtype):
        return (torch.randn((b, hq, tq, d), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype),
                torch.randn((b, hkv, tk, d), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype),
                torch.randn((b, hkv, tk, d), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype))

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    main = (LM_BATCH, 12, 2, LM_PROMPT, LM_PROMPT, 128)
    cases = [  # (B, Hq, Hkv, Tq, Tk, d), causal, types
        (main, True, (bf16,)),
        ((1, 12, 2, 100, 100, 128), True, (bf16, f16, f32)),      # ragged
        ((LM_BATCH, 12, 2, 1, LM_PROMPT + LM_GEN, 128), True,
         (bf16, f32)),                                            # decode-like
        ((2, 12, 2, 300, 1000, 128), True, (bf16, f16)),           # Tq < Tk
        ((1, 4, 2, 80, 50, 64), True, (bf16, f32)),                # Tq > Tk
        ((2, 12, 2, 512, 512, 128), False, (bf16, f32)),           # non-causal
        ((2, 8, 2, 256, 256, 64), True, (bf16, f16, f32)),         # d = 64
        ((LM_PARITY_BATCH, 4, 2, LM_PARITY_PROMPT, LM_PARITY_PROMPT, 16),
         True, (bf16, f32)),                                      # d = 16
    ]
    worst = {dt: 0.0 for dt in ATTN_TOL}      # max abs err
    ratio = {dt: 0.0 for dt in ATTN_TOL}      # max err / its bound
    launches = 0
    for shape, causal, dtypes in cases:
        for dt in dtypes:
            q, k, v = qkv(*shape, dt)
            got = ops.flash_attention(q, k, v, causal=causal, impl="cuda")
            want = ops.flash_attention(q, k, v, causal=causal, impl="ref")
            torch.cuda.synchronize()
            launches += 1
            check(got.dtype == dt and got.shape == want.shape,
                  f"flash_attention: output {got.dtype} {tuple(got.shape)}")
            e, r = attention_error(got, want, q, k, v, causal)
            worst[dt], ratio[dt] = max(worst[dt], e), max(ratio[dt], r)
            check(r <= 1, f"flash_attention {shape} causal={causal} {dt}: "
                  f"error {r:.3g} times its bound {ATTN_TOL[dt]} (max abs "
                  f"err {e})")
            del q, k, v, got, want
    say("kernels", f"flash_attention: {launches} cases on the card, max abs "
        f"err per type {{bf16: {worst[bf16]:.3g}, f16: {worst[f16]:.3g}, "
        f"f32: {worst[f32]:.3g}}}, largest error over its bound {{bf16: "
        f"{ratio[bf16]:.3g}, f16: {ratio[f16]:.3g}, f32: {ratio[f32]:.3g}}} "
        "(bound per element: 2^-7 |want| + 2^-8 sum_j p_j |v_j|, 2^-10 "
        "|want| + 2^-11 sum_j p_j |v_j|, capped at 2e-2 / 4e-3; 1e-4; "
        "both compute in float32 "
        "from the same inputs; bf16 / f16 round the output and the "
        "kernel's probabilities to 8 / 11 bits)")

    # the bound must see a fault on the late rows, where |o| is ~0.03:
    # the plain version with one 64-key tile left out stands in for a
    # kernel that skipped that tile
    b, hq, hkv, t, _, d = main
    q, k, v = qkv(*main, bf16)
    want = ops.flash_attention(q, k, v, impl="ref")
    e, r = attention_error(attention_without_keys(q, k, v, t // 2,
                                                  t // 2 + 64), want,
                           q, k, v)
    check(r > 1, f"flash_attention: the bound does not reject an output "
          f"with keys [{t // 2}, {t // 2 + 64}) left out ({r:.3g} of it)")
    say("kernels", f"flash_attention: with keys [{t // 2}, {t // 2 + 64}) "
        f"left out of every row at ({b}, {hq}, {t}, {d}) bf16, the error "
        f"is {r:.3g} times its bound (max abs err {e:.3g}): rejected")
    del want

    # timings at the LM prefill's shape
    kx = k.repeat_interleave(hq // hkv, dim=1)
    vx = v.repeat_interleave(hq // hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = {"ms": cuda_ms(lambda: ops.flash_attention(q, k, v, impl="cuda"),
                         20),
           "plain_ms": cuda_ms(lambda: ops.flash_attention(q, k, v,
                                                           impl="ref"), 3),
           "library_ms": cuda_ms(lambda: sdpa(q, kx, vx, is_causal=True), 20),
           "max_abs_err": worst[bf16]}
    device = kernel_device_ms(lambda: ops.flash_attention(q, k, v,
                                                          impl="cuda"),
                              20, "flash_attention")
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 2 * 2 * b * hq * d * causal_pairs(t, t, True)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    say("kernels", f"flash_attention ({b}, {hq}, {t}, {d}) over {hkv} KV "
        f"heads, bf16, causal: kernel_ms={rec['ms']:.4f} (device_ms="
        f"{device:.4f} alone, {flops / device / 1e9:.1f} TFLOP/s) "
        f"plain_ms={rec['plain_ms']:.3f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}: {flops:.4g} flop, {nbytes} bytes) "
        f"library_ms={rec['library_ms']:.4f} (one scaled_dot_product_"
        "attention call, K/V expanded to Hq: a yardstick only, the port "
        "never calls it)")
    return rec


# ------------------------------------------------------------- 4. parity

def phase_parity():
    """The whole path on the card and on the CPU, compared call by call."""
    from repro_torch.core.engine import DagEngine
    from repro_torch.interop import engine_to_arrays
    from repro_torch.launch import serve

    mixed = serve._sgt_churn_inputs(C_PARITY, B_PARITY_TILED, T_PARITY, 0,
                                    "mixed")
    streams = {
        "delheavy": (serve.churn_tick, "incremental", {}, B_PARITY,
                     serve._sgt_churn_inputs(C_PARITY, B_PARITY, T_PARITY, 0,
                                             "delheavy")),
        "steady": (serve.steady_tick, "auto", {}, B_PARITY,
                   serve._sgt_tick_inputs(C_PARITY, B_PARITY, T_PARITY, 0)),
        "tiled mixed": (serve.churn_tick, "incremental",
                        {"closure_layout": "tiled"}, B_PARITY_TILED, mixed),
        "tiled mixed, 64-slot window": (
            serve.churn_tick, "incremental",
            {"closure_layout": "tiled", "closure_region": 64},
            B_PARITY_TILED, mixed),
    }
    for name, (tick, method, layout, batch, inputs) in streams.items():
        engines = {d: DagEngine.create(C_PARITY, method=method, device=d,
                                       **layout)
                   for d in ("cuda", "cpu")}
        n_calls = 0
        t0 = time.perf_counter()
        for xs in inputs:
            results = {}
            for d in engines:
                engines[d], results[d] = tick(engines[d],
                                              serve.on_device(d, xs))
            for rc, rh in zip(results["cuda"], results["cpu"]):
                check(torch.equal(rc.ok.cpu(), rh.ok),
                      f"{name}: ok bits differ card vs CPU")
                check(int(rc.n_overflow) == int(rh.n_overflow),
                      f"{name}: n_overflow differs")
                for field, a, b in zip(rc.stats._fields, rc.stats, rh.stats):
                    check(np.array_equal(np.asarray(a), np.asarray(b)),
                          f"{name}: ReachStats.{field} differs: {a} vs {b}")
                n_calls += 1
            ac, ah = (engine_to_arrays(engines[d]) for d in ("cuda", "cpu"))
            for leaf in ac:
                check(np.array_equal(ac[leaf], ah[leaf]),
                      f"{name}: engine leaf {leaf} differs card vs CPU")
        say("parity", f"{name}: {T_PARITY} ticks, {n_calls} calls at "
            f"C={C_PARITY} B={batch} identical on card and CPU "
            f"(epoch {engines['cuda'].epoch}, dirty "
            f"{engines['cuda'].cache.dirty}, window "
            f"{engines['cuda'].closure_region}, "
            f"{time.perf_counter() - t0:.1f}s)")
    lm_parity()


def lm_parity():
    """The LM at smoke width in float32 on the card (B7 in its prefill)
    and on the CPU, from the same params and prompt: the prefill's
    last-token logits and cache, then 8 greedy decode steps."""
    import dataclasses

    from repro_torch.configs import lm_common, registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(
        lm_common.smoke_cfg(registry.lm_config(LM_ARCH)), dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_PARITY_BATCH, LM_PARITY_PROMPT)).astype(np.int64)
    runs = {}
    for d in ("cuda", "cpu"):
        on = {k: v.to(d) for k, v in params.items() if k != "layers"}
        on["layers"] = {k: v.to(d) for k, v in params["layers"].items()}
        runs[d] = serve.lm_generate(cfg, on, torch.from_numpy(prompt).to(d),
                                    LM_PARITY_STEPS + 1)
    card, cpu = runs["cuda"], runs["cpu"]
    err = {"prefill logits": (card["prefill_logits"].cpu()
                              - cpu["prefill_logits"])[:, :cfg.vocab]}
    for k in ("k", "v"):   # rows past the prompt hold the decode steps
        err[f"cache {k}"] = card["cache"][k].cpu() - cpu["cache"][k]
    err = {k: float(v.abs().max()) for k, v in err.items()}
    for k, e in err.items():
        check(e <= 1e-4, f"LM parity: {k} differs card vs CPU by {e}")
    check(torch.equal(card["tokens"].cpu(), cpu["tokens"]),
          "LM parity: greedy tokens differ card vs CPU")
    say("parity", f"LM {LM_ARCH} at smoke width, float32, batch "
        f"{LM_PARITY_BATCH}, prompt {LM_PARITY_PROMPT}: max abs diff card vs "
        f"CPU {err} (<= 1e-4); {LM_PARITY_STEPS} greedy decode steps, "
        f"tokens identical")


# ---------------------------------------------------------- 5. main path

def _launches_of(run):
    """Run ``run`` with the launch counters zeroed just before it; returns
    (its result, the launches it made)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def phase_main_path():
    """The dense serving runs through the CLI's default method ("auto"),
    then the tiled layout's serving run at C=131072, each with its launch
    counters zeroed just before it and read just after; the decision and
    validation checks come after that, outside the counted runs."""
    from repro_torch.core import closure_cache
    from repro_torch.launch import serve

    kw = dict(capacity=C_FULL, batch=B_FULL, method="auto", device="cuda")
    runs = [("steady", 10, lambda: serve.serve_sgt(api="engine", ticks=10,
                                                   **kw)),
            ("delheavy", 10, lambda: serve.serve_sgt_churn(
                profile="delheavy", ticks=10, **kw)),
            ("insheavy", 6, lambda: serve.serve_sgt_insert_heavy(ticks=6,
                                                                  **kw))]
    gen = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    total = {k: 0 for k in BIT_KERNELS}
    engines = {}
    for name, ticks, run in runs:
        t0 = time.perf_counter()

        def run_and_read(run=run):
            out = run()
            eng = out["engine"]
            live = eng.state.keys[eng.state.alive].cpu().numpy()
            pool = live if live.size else np.arange(C_FULL, dtype=np.int32)
            hits = eng.reachable(gen.choice(pool, 1024),
                                 gen.choice(pool, 1024))
            return out, live, hits

        (out, live, hits), launches = _launches_of(run_and_read)
        eng = out["engine"]
        for k in total:
            total[k] += launches[k]
        engines[name] = eng
        say("main", f"{name}: {out['ops_per_s']:.0f} ops/s (median tick), "
            f"row_products={out.get('row_products', 'n/a')} "
            f"repairs={out.get('n_repairs', 'n/a')} "
            f"live={live.size} edges={int(eng.edge_count())} "
            f"reachable hits={int(hits.sum())}/1024 epoch={eng.epoch} "
            f"launches {launches} over {ticks} ticks + 1 warm-up tick + "
            f"the queries ({time.perf_counter() - t0:.1f}s)")
    for name, eng in engines.items():
        check(closure_cache.cache_matches_state(eng.cache, eng.state.adj),
              f"{name}: the cache disagrees with a from-scratch closure")
        check(bool(eng.is_acyclic()), f"{name}: the graph has a cycle")
    del engines, eng, out

    # the tiled layout's main path
    tiled_kw = dict(capacity=C_TILED, batch=B_TILED, ticks=T_TILED,
                    method="incremental", profile="mixed",
                    closure_layout="tiled", collect_decisions=True,
                    device="cuda")
    t0 = time.perf_counter()
    tiled, launches = _launches_of(lambda: serve.serve_sgt_churn(**tiled_kw))
    for k in total:
        total[k] += launches[k]
    eng = tiled["engine"]
    say("main", f"tiled C={C_TILED} B={B_TILED}: {tiled['ops_per_s']:.0f} "
        f"ops/s (median tick), tick {tiled['tick_us'] / 1e3:.3f} ms, "
        f"closure_bytes={tiled['closure_bytes']} "
        f"cache_clean={tiled['cache_clean']} "
        f"row_products={tiled['row_products']} "
        f"repairs={tiled['n_repairs']} accepted={tiled['accepted']} "
        f"window={eng.closure_region} epoch={eng.epoch} launches "
        f"{launches} over {T_TILED} ticks + 1 warm-up tick "
        f"({time.perf_counter() - t0:.1f}s)")
    check(launches["closure_update_tiled"] > 0
          and launches["closure_delete_tiled"] > 0,
          f"the tiled main path did not launch B4 and B5: {launches}")
    say("main", f"launches on the main paths {total}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    check(all(v > 0 for v in total.values()),
          f"a kernel never launched on the SGT main paths: {total}")

    # checks, outside the counted runs
    check(closure_cache.region_confined(eng.state.adj, eng.closure_region),
          "the tiled engine has an edge outside its window")
    check(closure_cache.cache_matches_state(eng.cache, eng.state.adj),
          "tiled C=131072: the cache disagrees with a from-scratch closure "
          "of the window")
    check(bool(eng.is_acyclic()), "tiled C=131072: the graph has a cycle")
    check(tiled["closure_bytes"] == closure_cache.closure_nbytes(
        eng.cache.closure), "closure_bytes is not the resident closure")
    del eng, tiled["engine"]
    small = serve.serve_sgt_churn(closure_region=64, **tiled_kw)
    match = bool(np.array_equal(small["decisions"], tiled["decisions"]))
    say("main", f"tiled C={C_TILED}, 64-slot window: decisions_match="
        f"{match} ({small['decisions'].size} candidates), "
        f"cache_clean={small['cache_clean']} "
        f"row_products={small['row_products']} "
        f"repairs={small['n_repairs']} "
        f"closure_bytes={small['closure_bytes']}")
    check(match, "tiled C=131072: the 64-slot window decides differently")
    del small
    pair = {layout: serve.serve_sgt_churn(
        capacity=C_FULL, batch=B_FULL, ticks=T_TILED, method="incremental",
        profile="mixed", closure_layout=layout, collect_decisions=True,
        device="cuda") for layout in ("dense", "tiled")}
    match = bool(np.array_equal(pair["dense"]["decisions"],
                                pair["tiled"]["decisions"]))
    say("main", f"C={C_FULL} B={B_FULL} mixed, {T_TILED} ticks: tiled vs "
        f"dense decisions_match={match}; closure_bytes "
        f"{pair['tiled']['closure_bytes']} vs {pair['dense']['closure_bytes']}")
    check(match, f"C={C_FULL}: the tiled layout decides differently from "
          "the dense one")
    for layout, out in pair.items():
        eng = out["engine"]
        check(closure_cache.cache_matches_state(eng.cache, eng.state.adj),
              f"C={C_FULL} {layout}: the cache disagrees with a "
              "from-scratch closure")
        check(bool(eng.is_acyclic()), f"C={C_FULL} {layout}: a cycle")
    say("main", "every run: cache_matches_state and is_acyclic hold")
    return total


# ---------------------------------------------------------------- 6. lm

def phase_lm():
    """`serve_lm` at full width: a warm-up call, then the counted run;
    then one profiled prefill for B7's share of it.  Returns the counted
    run's launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.launch.profile_ticks import _device_us
    from repro_torch.models import transformer as T

    kw = dict(arch=LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT,
              device="cuda", width="full")
    t0 = time.perf_counter()
    serve.serve_lm(gen=2, **kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, launches = _launches_of(lambda: serve.serve_lm(gen=LM_GEN, **kw))
    peak = torch.cuda.max_memory_allocated()
    cfg = out["cfg"]
    vocab = cfg.vocab
    say("lm", f"{LM_ARCH} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads, d_ff {cfg.d_ff}, "
        f"vocab {vocab} padded to {cfg.padded_vocab}, {cfg.dtype}), batch "
        f"{LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} greedy tokens: prefill "
        f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms_per_token']:.3f}"
        f" ms/token, {out['tok_per_s']:.1f} tokens/s, peak memory "
        f"{peak / 2**20:.0f} MiB, launches {launches} "
        f"({time.perf_counter() - t0:.1f}s with the warm-up)")
    check(launches["flash_attention"] == cfg.n_layers,
          f"the prefill launched B7 {launches['flash_attention']} times, "
          f"not once per layer ({cfg.n_layers})")
    check(all(v == 0 for k, v in launches.items() if k != "flash_attention"),
          f"the LM path launched a bit kernel: {launches}")
    for name in ("prefill_logits", "logits"):
        check(bool(torch.isfinite(out[name][:, :vocab].float()).all()),
              f"LM: non-finite {name}")
    toks = out["tokens"]
    check(tuple(toks.shape) == (LM_BATCH, LM_GEN)
          and int(toks.min()) >= 0 and int(toks.max()) < vocab,
          f"LM: tokens {tuple(toks.shape)} outside [0, {vocab})")

    # B7's share of one prefill's device time (outside the counted run)
    params, prompt = out["params"], out["prompt"]
    del out
    T.prefill(cfg, params, prompt, max_len=LM_PROMPT + LM_GEN)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        T.prefill(cfg, params, prompt, max_len=LM_PROMPT + LM_GEN)
        torch.cuda.synchronize()
    events = [(e.key, _device_us(e), e.count) for e in prof.key_averages()]
    total = sum(us for _, us, _ in events)
    flash = sum(us for k, us, _ in events if "flash_attention_kernel" in k)
    top = sorted(events, key=lambda e: -e[1])[:5]
    say("lm", f"one profiled prefill: device busy {total / 1e3:.3f} ms, B7 "
        f"{flash / 1e3:.3f} ms ({flash / max(total, 1e-9):.1%}); top "
        "kernels " + "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{n}"
                               for k, us, n in top))

    # one profiled decode step: wall, device busy, kernels launched
    logits, cache = T.prefill(cfg, params, prompt,
                              max_len=LM_PROMPT + LM_GEN)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    T.decode_step(cfg, params, cache, cur, LM_PROMPT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        T.decode_step(cfg, params, cache, cur, LM_PROMPT + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    events = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
              if _device_us(e) > 0]
    busy = sum(us for _, us, _ in events) / 1e3
    top = sorted(events, key=lambda e: -e[1])[:4]
    say("lm", f"one profiled decode step: wall {wall:.3f} ms (profiler on), "
        f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
        f"{sum(n for _, _, n in events)} device operations; top "
        + "; ".join(f"{k[:50]} {us / 1e3:.3f} ms x{n}" for k, us, n in top))
    return launches


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    # the SGT path's small float32 products hold 0/1 values (exact either
    # way) and the LM parity run compares float32 card and CPU: full
    # float32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    records = phase_kernels()
    phase_parity()
    launches = phase_main_path()
    launches["flash_attention"] = phase_lm()["flash_attention"]
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f}s")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
