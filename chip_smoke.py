"""Smoke run of the PyTorch / CUDA port on one card.

    python3 chip_smoke.py

Phases, one status line each; the first failure raises and exits
non-zero:
  1. device     — the card's name and power limit (no card: exit 2).
  2. build      — nvcc builds kernels B1-B7 from src/repro_torch/csrc;
                  registers and shared memory per kernel (-Xptxas -v);
                  B1-B3's main kernels must not spill; B7's bf16
                  and f16 instantiations must hold wgmma (HGMMA) and no
                  mma.sync (HMMA), B1-B3's main kernels integer
                  wgmma (IGMMA) in their SASS (cuobjdump, where the
                  toolkit has it).
  3. kernels    — every kernel bit-identical to its plain torch version
                  at the shapes and densities of tests/test_kernels.py
                  (B1-B3); B1 and B3 also over densities 0, 1, 5, 25,
                  50 and 100%, block-mixed operands (alternate 128-row
                  blocks 1% and full: both paths in one launch), ragged
                  M, K and N, lhs is rhs, the frontier hop, B3 with no,
                  a quarter of and every row affected; B2 over mask
                  densities 0-100% across the threshold, block-mixed
                  masks, C = 320 and 1056 at B = 32, 96 and 1024, an
                  all-ones closure and the main path's shape at 1% and
                  50%; each case as the
                  main path calls it and with every block forced down
                  each path; and over windows R in {32, 96, 1024, 4096},
                  densities 0 / 1% / 25% / 100%, all-live and no-live
                  bands (B4, B5, occupancy included), over lhs rows
                  with exactly 0, 1, 7, 8, 9, 31, 32, 33 and all set
                  bits or one full word (the batch edges of B4/B5's
                  gathers) at R in {96, 1024, 4096}, B4 at B = 128 and
                  1024, B5 with every row affected; and at the main
                  paths' shapes (C=16384, B=1024 dense; R=1024, B=128
                  tiled), each kernel timed turn for turn against its
                  library yardstick (5 rounds of kernel, library,
                  library, kernel; the median turn of each side),
                  beside the plain version and the least time the card
                  could take (bound); kernel_ms is per call (CUDA
                  events), device_ms the kernel alone (torch.profiler),
                  host_ms the wall time per call of calls issued without
                  a sync; each B1-B3 line gives the share of its 128-row
                  blocks above the dense threshold, from the operands.
                  B1's "crossover" line times its two paths, every block
                  forced, on the C=16384 squaring at 1-50% density (the
                  measurement behind the threshold) and on the frontier
                  hop; B2 is timed with a 1% and a 50% dense mask, its
                  crossover line times both paths on the C=16384,
                  B=1024 fold at mask densities 1-50%, and it is timed
                  on the last fold of the insheavy and of the delheavy
                  stream (captured through the engine's
                  closure_update_impl hook; mask bits and dense-block
                  share printed); then B1
                  squares the closure of a seeded 1%-dense
                  upper-triangular DAG (C=16384, ~47% dense) and B3 runs
                  with every row of it affected, each timed against the
                  fp16 matmul.  Then B5's device time at R = 1024 with one
                  row, one band and every row affected (10 bits a row),
                  the host cost of the ways to allocate B4/B5's two
                  outputs, turn for turn, and B5's host time a call step
                  by step.
                  B7 (flash attention) against its
                  plain version in bf16, f16 and f32 at the LM main path's
                  shape (4, 12, 2048, 128) over 2 KV heads, a ragged T,
                  a decode-like Tq=1 / Tk=2080, Tq < Tk and Tq > Tk,
                  non-causal, d = 64, 32 (Tk = 2049, 6 query heads a KV
                  head) and 16, every element within
                  its rounding bound (ATTN_TOL: bf16 2^-7 |want| +
                  2^-8 sum_j p_j |v_j|, f16 2^-10 and 2^-11, capped at
                  2e-2 / 4e-3; f32 1e-4);
                  the same bound must reject the main shape's output
                  with 64 keys left out; its library yardstick is one
                  scaled_dot_product_attention call, timed turn for turn
                  with B7 (kernel, SDPA, SDPA, kernel), with B7's TFLOP/s
                  and its ptxas registers, shared memory and spills.  B6 (the
                  embedding bag) against its plain version at the shapes
                  of tests/test_kernels.py in f32 and bf16 with 0-weight
                  padding, at ragged widths, at the xDeepFM main path's
                  (R=33,001,472, D=1, B=512, K=39, f32, unit weights) and
                  at kernel_bench's (R=1,000,000, D=64, B=4096, K=4), and
                  over K in {1, 2, 31, 32, 33, 39, 64, 100}, D in {1, 2,
                  3, 4, 8} and B in {1, 7, 512} (both of its paths), every
                  element within its rounding bound (K 2^-23
                  sum_k |w_k t_k|, plus 2^-7 |want| in bf16); the bound
                  must reject the main shape's output with one k term
                  left out; the two timed shapes print the path they
                  took; its library yardstick is one
                  F.embedding_bag(mode="sum") call.
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
                  steps, from the same params and prompt; xDeepFM at the
                  reduced config of tests/test_recsys.py (float32, TF32
                  off): forward, loss and retrieval scores within 1e-5 of
                  the CPU's, from the same params and ids.
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
  7. recsys     — full-width xDeepFM (configs/xdeepfm.py: 39 fields, embed
                  10, CIN 200-200-200, MLP 400-400, 33,001,472 table rows,
                  1,000,000 items x 64; float32, random from seed 0):
                  serve_p99 (batch 512) after a warm-up, 20 timed forward
                  calls with the counters zeroed just before them (ms per
                  batch, samples/s; B6 launched once per call); then
                  retrieval_cand (one query against 1,000,000 candidates,
                  ms); peak memory and the top device kernels of one
                  profiled forward (B6's share) and of one profiled query.
                  Logits and scores finite.
  8. replication — (a) a `replica.Primary` writer on the card and on the
                  CPU, eager and defer_flush + jit, over the delheavy and
                  steady streams at C=2048, B=256, 8 ticks: the two logs
                  equal entry for entry, CRC for CRC; two replicas on the
                  card replay the card's log to the CPU writer's
                  adjacency and closure bit for bit.  (b) The dense main
                  path's steady and delheavy streams (C=16384, B=1024, 10
                  ticks) through a defer_flush + jit writer ("auto"), two
                  replicas replaying each tick's entries: writer tick ms,
                  replay ms an entry, the replay's B2 / B3 launches,
                  convergence; a checkpoint after tick 5 plus
                  save_delta_log of the whole log, recovered by
                  recover_replica and converged bit for bit (save and
                  recovery ms); serve_sgt_replicated reads/s from 0 and 2
                  snapshot readers (row_products == 0).  (c) The tiled
                  main path's mixed stream (C=131072, B=128, 10 ticks,
                  "incremental") the same way: the replay's B4 / B5
                  launches, convergence, and 1024 replica reads equal to
                  the engine's.  (d) serve_chaos on every named fault
                  plan, seed 11, C=2048, B=256, 10 ticks, on the card and
                  on the CPU: wrong_answers == 0, the same counters.  (e)
                  The front-end at C=16384 with batch 64, a 2 ms wait and
                  2 replicas: the rate with every tick full (a burst),
                  one profiled tick (launches, device busy; and the same
                  tick at subbatches=1, for its cost only), then
                  serve_frontend with the snapshot and the replica reader
                  at 25% and 80% of that rate, 4 s each: p50, p99, shed,
                  row_products.  (b) and (c) also profile one replay of
                  the last tick's entries.  The replay's launches of B2-B5 are added
                  to the kernels line's counts.
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
F32_FLOP_PER_S = 67e12          # H100 SXM data sheet, float32 without tensor cores
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
# B6 against its plain version, per element: |got - want| <= K 2^-23
# sum_k |w_k t_k| (+ 2^-7 |want| for a bf16 table).  Both form each
# product w t in float32 and sum the K products in float32, in other
# orders: each of the K additions rounds by at most 2^-24 of a partial
# sum no larger than sum_k |w_k t_k|, so two orders differ by at most
# 2 K 2^-24 of it.  A bf16 output rounds those two float32 sums to the
# nearest bf16 each, which can fall on neighbouring values: one ulp,
# 2^-7 of the value.
EMB_ULP_F32, EMB_ULP_BF16 = 2.0 ** -23, 2.0 ** -7
REC_STEPS = 20                  # timed forward calls at serve_p99
TURNS = 5                       # rounds of turns timing a bit kernel
BIT_KERNELS = ("bitmm", "closure_update", "closure_delete",
               "closure_update_tiled", "closure_delete_tiled")
# the kernels on csrc/bitgemm.cuh's two paths (a count launch, then gather
# lists or int8 wgmma a 128-row block)
BITGEMM_KERNELS = ("bitmm", "closure_update", "closure_delete")

# -Xptxas -v per kernel instantiation (phase 2): registers, static shared
# memory, spills
PTXAS: dict = {}
# B7's dynamic shared memory a block, by head dim (csrc/flash_attention.cu
# Tile<D>: Q and O buffers of 128 rows, two stages of 128-key K and V
# tiles, 10 mbarriers, 1024 bytes of alignment slack)
B7_SMEM = {d: 2 * 128 * d * 2 + 2 * 2 * 128 * d * 2 + 8 * 10 + 1024
           for d in (16, 32, 64, 128)}

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
    "embbag": ("src/repro_torch/csrc/embbag.cu",
               "src/repro/kernels/embbag.py:48"),
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
            t = re.search(r"flash_attention_f32_kernelILi(\d+)E",
                          m.group(1))
            if t:
                kernel = f"flash_attention<float, d={t.group(1)}>"
            t = re.search(r"embbag_kernel(_ksplit)?ILb([01])ELi(\d+)E",
                          m.group(1))
            if t:   # one instantiation per (path, type, load width)
                kernel = (f"embbag{' k split' if t.group(1) else ''}<"
                          f"{'bf16' if t.group(2) == '1' else 'f32'}, "
                          f"vec={t.group(3)}>")
            t = re.search(r"(bitmm|closure_update|closure_delete)_work_kernel",
                          m.group(1))
            if t:   # B1-B3's first launch
                kernel = f"{t.group(1)} work"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            PTXAS.setdefault(kernel, {}).update(
                registers=int(m.group(1)),
                static_smem=int(smem.group(1)) if smem else 0)
            say("build", f"{kernel}: {m.group(1)} registers, "
                f"{smem.group(1) if smem else 0} bytes static shared memory")
        if "spill" in line and kernel:
            PTXAS.setdefault(kernel, {})["spills"] = line.strip()
            say("build", f"{kernel}: {line.strip()}")
        if "wgmma" in line.lower() and "serializ" in line.lower():
            say("build", f"ptxas: {line.strip()}")
    bitgemm_spills()
    check_sass(lib)


def bitgemm_spills() -> None:
    """B1-B3's main kernels (dense path: 128 int32 accumulators a consumer
    thread) must not spill."""
    for kernel in BITGEMM_KERNELS:
        line = PTXAS.get(kernel, {}).get("spills", "")
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        check(found is not None and found.groups() == ("0", "0"),
              f"{kernel} must not spill registers: ptxas says {line!r}")
    say("build", "B1-B3's main kernels: no spills")


def check_sass(lib) -> None:
    """B7's bf16 and f16 instantiations must compute their products with
    wgmma (HGMMA in the SASS) and hold no mma.sync (HMMA); B1-B3's main
    kernels (their dense path) must hold integer wgmma (IGMMA)."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        say("build", f"{tool} not found: the SASS is not checked")
        return
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600).stdout
    found, integer = {}, {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        t = re.search(r"flash_attention_kernelI(\w+?)Li(\d+)E", name)
        if t:
            found[f"{t.group(1)}, d={t.group(2)}"] = (
                len(re.findall(r"\bHGMMA\b", body)),
                len(re.findall(r"\bHMMA\b", body)))
        t = re.search("|".join(f"{k}_kernel" for k in BITGEMM_KERNELS),
                      name)
        if t:
            integer[t.group(0)] = len(re.findall(r"\bIGMMA\b", body))
    check(len(found) == 8 and all(g > 0 and h == 0
                                  for g, h in found.values()),
          f"B7's 16-bit instantiations must use wgmma and no mma.sync: "
          f"(HGMMA, HMMA) per instantiation {found}")
    say("build", "B7's 16-bit instantiations compute with wgmma: (HGMMA, "
        f"HMMA) in the SASS of each {found}")
    check(len(integer) == len(BITGEMM_KERNELS)
          and all(n > 0 for n in integer.values()),
          f"B1-B3's main kernels must use integer wgmma: IGMMA per kernel "
          f"{integer}")
    say("build", f"B1-B3's dense path computes with integer wgmma: IGMMA "
        f"in the SASS of each {integer}")


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


def profiled(fn, reps: int):
    """`torch.profiler` key averages of ``reps`` calls of ``fn`` (CUDA
    activity only), after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def kernel_device_parts(fn, reps: int, kernel: str):
    """Mean device milliseconds per launch of the CUDA kernel named
    ``kernel`` and of its first launch (``kernel``_work_kernel: B1-B3
    count each row block's work before the product; 0.0 for the others)
    over ``reps`` calls of ``fn``, from `torch.profiler`: the kernels
    alone, without the host time of the wrapper (which sets the per-call
    time of a kernel shorter than its launch)."""
    from repro_torch.launch.profile_ticks import _device_us

    keys = profiled(fn, reps)
    parts = []
    for tag in ("_kernel", "_work_kernel"):
        events = [e for e in keys if f"{kernel}{tag}" in e.key]
        # the mean over the launches the profiler recorded (it may drop one)
        launches = sum(e.count for e in events)
        check(launches > 0 or tag != "_kernel",
              f"the profiler saw no launch of {kernel}")
        parts.append(sum(_device_us(e) for e in events) / 1e3
                     / max(launches, 1))
    return tuple(parts)


def kernel_device_ms(fn, reps: int, kernel: str) -> float:
    """Device milliseconds of a call of ``fn``: its kernel's launch plus,
    for B1-B3, their first launch (`kernel_device_parts`)."""
    return sum(kernel_device_parts(fn, reps, kernel))


def device_ms_per_call(fn, reps: int) -> float:
    """Device milliseconds of every kernel ``fn`` launches, per call over
    ``reps`` calls, from `torch.profiler`."""
    from repro_torch.launch.profile_ticks import _device_us

    return sum(_device_us(e) for e in profiled(fn, reps)) / 1e3 / reps


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


def fp16_matmul(lhs_packed, rhs_packed):
    """The library yardstick: a call of one fp16 torch.matmul of the
    unpacked operands (no packed boolean product exists as one PyTorch
    call)."""
    from repro_torch.core import bitset
    a = bitset.unpack_bits(lhs_packed).to(torch.float16)
    b = bitset.unpack_bits(rhs_packed).to(torch.float16)
    return lambda: torch.matmul(a, b)


def host_ms(fn, reps: int) -> float:
    """Wall milliseconds per call (time.perf_counter) of ``reps`` calls
    issued without a sync, after one warm-up call: the host's time to
    issue a call, whatever the device does meanwhile."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def exact_bit_rows(counts, n: int, width: int, gen):
    """(n, width/32) packed rows; row i holds exactly counts[i % len]
    set bits at random columns (a count of None: every bit)."""
    from repro_torch.core import bitset
    c = torch.tensor([width if k is None else k for k in counts],
                     device="cuda")
    c = c[torch.arange(n, device="cuda") % len(counts)]
    rank = torch.rand((n, width), generator=gen,
                      device="cuda").argsort(1).argsort(1)
    return bitset.pack_bits(rank < c[:, None])


# set-bit counts of an lhs row at the batch edges of B4/B5's gathers
# (or_selected_rows_batched: 8 loads in flight, 32 indices a pass), and
# every bit of the row
GATHER_EDGES = (0, 1, 7, 8, 9, 31, 32, 33, None)


def gather_edge_rows(n: int, width: int, gen):
    """exact_bit_rows over GATHER_EDGES, two in three of its empty rows
    made rows whose bits fill one word: the first word (rows 0, 27, ...)
    or the last (rows 9, 36, ...)."""
    rows = exact_bit_rows(GATHER_EDGES, n, width, gen)
    rows[0::27, 0] = -1
    rows[9::27, -1] = -1
    return rows


def allocation_turns(like: torch.Tensor, reps: int = 2000):
    """Host us per call of the ways to allocate the tiled kernels' out
    (R, R/32) and occ (R/32, R/32) beside the (R, R/32) operand
    ``like``, turn for turn (each way, then all again in reverse); the
    wrappers take the last."""
    r, w = like.shape
    dev = like.get_device()
    ways = {
        "two torch.empty": lambda: (
            torch.empty((r, w), dtype=torch.int32, device=dev),
            torch.empty((r // 32, w), dtype=torch.int32, device=dev)),
        "one torch.empty split in two": lambda: torch.empty(
            (r + r // 32, w), dtype=torch.int32,
            device=dev).split_with_sizes((r, r // 32)),
        "empty_like + new_empty (the wrappers')": lambda: (
            torch.empty_like(like), like.new_empty((r // 32, w))),
    }
    us = {k: 0.0 for k in ways}
    for k in list(ways) + list(reversed(ways)):
        us[k] += host_ms(ways[k], reps) * 1e3 / 2
    return us


def launch_path_steps(r_packed, s_packed, aff, reps: int = 2000):
    """Host us per call of each step of B5's call (and of its library
    yardstick) on the given operands, in the order the call takes them;
    the bare ctypes calls bypass the wrapper and its launch count."""
    from repro_torch.kernels import _build, closure_delete, ops
    from repro_torch.kernels.ops import _resolve

    dev = r_packed.get_device()
    r, w = r_packed.shape
    out, occ = torch.empty_like(r_packed), r_packed.new_empty((w, w))
    fn = _build._FUNCTIONS["repro_closure_delete_tiled"]
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ptrs = [x.data_ptr() for x in (r_packed, s_packed, aff, out, occ)]
    operands = ((r_packed, "r", 2, _build.INT32),
                (s_packed, "s", 2, _build.INT32),
                (aff, "affected", 1, _build.INT32))
    library = fp16_matmul(r_packed, s_packed)
    steps = {
        "ops.closure_delete_tiled (the whole call)": lambda:
            ops.closure_delete_tiled(r_packed, s_packed, aff, impl="cuda"),
        "the wrapper alone": lambda:
            closure_delete.closure_delete_tiled(r_packed, s_packed, aff),
        "ops._resolve": lambda: _resolve("cuda", r_packed),
        "check_operands": lambda: _build.check_operands(*operands),
        "empty_like + new_empty": lambda: (torch.empty_like(r_packed),
                                           r_packed.new_empty((w, w))),
        "five data_ptr()": lambda: (r_packed.data_ptr(), s_packed.data_ptr(),
                                    aff.data_ptr(), out.data_ptr(),
                                    occ.data_ptr()),
        "stream and device getters": lambda: (
            torch._C._cuda_getCurrentRawStream(dev),
            torch._C._cuda_getDevice()),
        "ctypes call, R = 0 (no launch)": lambda: fn(*ptrs, 0, 0, stream),
        "ctypes call launching the kernel": lambda: fn(*ptrs, r, w, stream),
        "library: one fp16 torch.matmul": library,
    }
    return {k: host_ms(f, reps) * 1e3 for k, f in steps.items()}


def dense_share(lhs, affected=None) -> float:
    """The share of B1's / B3's 128-row blocks above the compiled
    threshold, from the operands on the host side: each block's set lhs
    bits (B3: of its affected rows) against kDensePerMille of its 128 x K
    cells, as the kernels' first launch counts them."""
    from repro_torch.core import bitset
    from repro_torch.kernels import bitmm

    m, wk = lhs.shape
    bits = bitset.popcount(lhs).to(torch.int64)   # per row
    if affected is not None:
        bits = bits * bitset.unpack_bits(affected)[:m].to(torch.int64)
    blocks = (m + 127) // 128
    work = torch.zeros(blocks * 128, dtype=torch.int64, device=lhs.device)
    work[:m] = bits
    work = work.view(blocks, 128).sum(1).cpu().numpy()
    dense = work * 1000 > bitmm.dense_per_mille() * 128 * 32 * wk
    return float(dense.mean())


def forced_works(m: int, device):
    """Work arrays that send every 128-row block down one path: all
    sparse (0) and all dense (the int32 maximum)."""
    blocks = (m + 127) // 128
    return (torch.zeros(blocks, dtype=torch.int32, device=device),
            torch.full((blocks,), 2 ** 31 - 1, dtype=torch.int32,
                       device=device))


def block_mixed(m: int, k: int, gen, sparse=0.01):
    """(m, k/32) packed rows whose 128-row blocks alternate between 1%
    dense and full, starting sparse."""
    x = packed((m, k), sparse, gen)
    for b0 in range(128, m, 256):
        x[b0:b0 + 128] = -1
    return x


def b1_b3_cases(gen, err) -> int:
    """B1 and B3 bit for bit against their plain versions, each case
    three ways: the call as the main path makes it (each block on the
    path its count picks) and the main launch with every block forced
    sparse or dense.  Densities 0, 1,
    5, 25, 50 and 100%, block-mixed operands (alternate 128-row blocks
    1% and full), ragged M, K and N, lhs is rhs, the frontier hop and the
    tiled rebuild's window, B3 with no, a quarter of and every row
    affected.  Returns the number of cases; updates err."""
    from repro_torch.kernels import bitmm, closure_delete, ops

    n_cases = 0

    def b1(lhs, rhs):
        nonlocal n_cases
        want = ops.bitmm_packed(lhs, rhs, impl="ref")
        sparse, dense = forced_works(lhs.shape[0], lhs.device)
        for got in (ops.bitmm_packed(lhs, rhs, impl="cuda"),
                    bitmm.bitmm_paths(lhs, rhs, sparse),
                    bitmm.bitmm_paths(lhs, rhs, dense)):
            err["bitmm"] = max(err["bitmm"], mismatch(got, want))
        n_cases += 1

    def b3(r, s, aff):
        nonlocal n_cases
        want = ops.closure_delete(r, s, aff, impl="ref")
        sparse, dense = forced_works(r.shape[0], r.device)
        for got in (ops.closure_delete(r, s, aff, impl="cuda"),
                    closure_delete.closure_delete_paths(r, s, aff, sparse),
                    closure_delete.closure_delete_paths(r, s, aff, dense)):
            err["closure_delete"] = max(err["closure_delete"],
                                        mismatch(got, want))
        n_cases += 1

    densities = (0.0, 0.01, 0.05, 0.25, 0.5, 1.0)
    # ragged M, K and N: capacities are multiples of 32, not of 128 or 256
    for m, k, n in [(512, 2048, 2048), (200, 160, 288), (33, 96, 160),
                    (1000, 1056, 800)]:
        for d in densities:
            b1(packed((m, k), d, gen), packed((k, n), d, gen))
        b1(block_mixed(m, k, gen), packed((k, n), 0.25, gen))
    for c in (1024, 2080):          # lhs is rhs; the tiled rebuild's window
        for d in densities:
            x = packed((c, c), d, gen)
            b1(x, x)
        x = block_mixed(c, c, gen)
        b1(x, x)
    for d in (0.01, 0.5):           # the frontier hop
        b1(packed((B_FULL, C_FULL), d, gen), packed((C_FULL, C_FULL), d, gen))
    for c in (128, 320, 1024, 2080):
        for d in (0.01, 0.25, 1.0):
            for af in (0.0, 0.25, 1.0):
                b3(packed((c, c), d, gen), packed((c, c), d, gen),
                   packed((c,), af, gen))
        b3(block_mixed(c, c, gen), packed((c, c), 0.05, gen),
           packed((c,), 0.5, gen))
    return n_cases


def b2_cases(gen, err) -> int:
    """B2 bit for bit against its plain version, each case as the main
    path calls it and with every block forced sparse or dense: the shapes
    of tests/test_kernels.py at closure densities 0, 5 and 50%; C = 320
    and 1056 (not multiples of 128) at B = 32, 96 and 1024; mask densities
    0-100% across the threshold; an all-ones closure; block-mixed masks
    (alternate 128-row blocks 1% and full); the main path's C = 16384,
    B = 1024 at 1% and 50%.  Returns the number of cases; updates err."""
    from repro_torch.kernels import closure_update, ops

    n_cases = 0

    def b2(closure, mask, rows):
        nonlocal n_cases
        want = ops.closure_update(closure, mask, rows, impl="ref")
        sparse, dense = forced_works(closure.shape[0], closure.device)
        for got in (ops.closure_update(closure, mask, rows, impl="cuda"),
                    closure_update.closure_update_paths(closure, mask, rows,
                                                        sparse),
                    closure_update.closure_update_paths(closure, mask, rows,
                                                        dense)):
            err["closure_update"] = max(err["closure_update"],
                                        mismatch(got, want))
        n_cases += 1

    for c, b in [(128, 32), (256, 64), (512, 256), (1024, 32), (320, 64)]:
        for d in (0.0, 0.05, 0.5):
            b2(packed((c, c), d, gen), packed((c, b), 0.2, gen),
               packed((b, c), 0.1, gen))
    for c in (320, 1056):
        for b in (32, 96, 1024):
            for md in (0.0, 0.01, 0.05, 0.07, 0.09, 0.12, 0.3, 1.0):
                b2(packed((c, c), 0.01, gen), packed((c, b), md, gen),
                   packed((b, c), 0.05, gen))
            b2(torch.full((c, c // 32), -1, dtype=torch.int32,
                          device="cuda"),
               packed((c, b), 0.3, gen), packed((b, c), 0.3, gen))
            b2(packed((c, c), 0.01, gen), block_mixed(c, b, gen),
               packed((b, c), 0.25, gen))
    for md in (0.01, 0.5):
        b2(packed((C_FULL, C_FULL), 0.01, gen), packed((C_FULL, B_FULL), md,
                                                       gen),
           packed((B_FULL, C_FULL), 0.01, gen))
    return n_cases


def forced_crossover(name, m, densities, operands, paths, reps):
    """``name``'s main launch with every block forced sparse, then dense,
    at each density d: ``paths(*operands(d), work)``, ms a call (CUDA
    events; ``reps`` = (calls below 10%, calls from 10%)); the two paths
    agree bit for bit.  Returns [(d, {"sparse": ms, "dense": ms})]."""
    sparse, dense = forced_works(m, "cuda")
    out = []
    for d in densities:
        args = operands(d)
        outs, ms = [], {}
        for label, work in (("sparse", sparse), ("dense", dense)):
            def fn(work=work):
                return paths(*args, work)
            outs.append(fn())
            ms[label] = cuda_ms(fn, reps[d >= 0.1])
        check(torch.equal(outs[0], outs[1]),
              f"{name}'s paths disagree at {d:.0%} density")
        out.append((d, ms))
        del args, outs
    return out


def path_times(rows) -> str:
    return "; ".join(f"{d:.0%} " + " ".join(f"{k} {v:.4f}"
                                           for k, v in ms.items())
                     for d, ms in rows)


def crossover(gen) -> None:
    """B1's two paths at one shape, the C=16384 squaring (lhs is rhs) at
    densities 1% .. 50%, and the frontier hop at 1% (`forced_crossover`).
    The threshold (kDensePerMille) is set from where the sparse time
    crosses the dense one."""
    from repro_torch.kernels import bitmm

    c = C_FULL

    def square(d):
        x = packed((c, c), d, gen)
        return x, x

    rows = forced_crossover("B1", c, (0.01, 0.02, 0.05, 0.1, 0.25, 0.5),
                            square, bitmm.bitmm_paths, (5, 2))
    say("kernels", f"bitmm crossover, C={c} squaring (lhs is rhs), ms a "
        f"main launch by path: {path_times(rows)}")
    front, rhs = packed((B_FULL, c), 0.01, gen), packed((c, c), 0.01, gen)
    hop = forced_crossover("B1", B_FULL, (0.01,), lambda d: (front, rhs),
                           bitmm.bitmm_paths, (20, 20))
    say("kernels", f"bitmm frontier hop ({B_FULL}, {c // 32}) x ({c}, "
        f"{c // 32}), 1%, ms a main launch by path: {path_times(hop)}"
        f"; compiled threshold {bitmm.dense_per_mille()} per mille")


def b2_crossover(closure, rows, gen) -> None:
    """B2's two paths on the C=16384, B=1024 fold (K = B) at mask
    densities 1% .. 50%, rows 1% dense (`forced_crossover`).  B1's
    crossover (K = 16384) set the shared threshold; this line shows where
    B2's lies."""
    from repro_torch.kernels import closure_update

    times = forced_crossover(
        "B2", C_FULL, (0.01, 0.02, 0.05, 0.1, 0.2, 0.5),
        lambda d: (closure, packed((C_FULL, B_FULL), d, gen), rows),
        closure_update.closure_update_paths, (20, 5))
    say("kernels", f"closure_update crossover, C={C_FULL} B={B_FULL} fold "
        f"(K = B), rows 1% dense, ms a main launch by path: "
        f"{path_times(times)}")


def dense_closure(gen):
    """The closure of a seeded 1%-dense random upper-triangular DAG at
    C=16384, built on the card by repeated squaring (B1)."""
    from repro_torch.core import bitset, reachability

    adj = torch.rand((C_FULL, C_FULL), generator=gen, device="cuda") < 0.01
    adj = bitset.pack_bits(torch.triu(adj, diagonal=1))
    t0 = time.perf_counter()
    r, n = reachability.transitive_closure(adj, with_stats=True)
    torch.cuda.synchronize()
    density = popcount_total(r) / C_FULL ** 2
    say("kernels", f"dense closure: C={C_FULL}, 1%-dense upper-triangular "
        f"DAG, {n} squarings, {density:.1%} dense, "
        f"{time.perf_counter() - t0:.2f}s")
    return r, density


def phase_kernels():
    """Bit-identity sweeps plus timings; returns {kernel: record}."""
    from repro_torch.kernels import ops
    from repro_torch.launch.tiled_call_turns import captured_fold

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
    n_b2 = b2_cases(gen, err)
    n_cases += n_b2
    for c in (128, 320, 512, 1024):
        for af in (0.0, 0.25, 1.0):
            args = (packed((c, c), 0.05, gen), packed((c, c), 0.05, gen),
                    packed((c,), af, gen))
            err["closure_delete"] = max(err["closure_delete"], mismatch(
                ops.closure_delete(*args, impl="cuda"),
                ops.closure_delete(*args, impl="ref")))
            n_cases += 1
    n_b1_b3 = b1_b3_cases(gen, err)
    n_cases += n_b1_b3
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
    # lhs rows with exactly 0, 1, 7, 8, 9, 31, 32, 33 and all set bits,
    # and rows whose bits fill one word: B5 with every row affected (its
    # lhs is r's row) at R = 96, 1024 and 4096; B4 with them as fold-mask
    # rows at B = 128 and B = 1024
    for r in (96, 1024, 4096):
        dele = (gather_edge_rows(r, r, gen), packed((r, r), 0.05, gen),
                packed((r,), 1.0, gen))
        for b in (B_TILED, 1024):
            upd = (packed((r, r), 0.01, gen), gather_edge_rows(r, b, gen),
                   packed((b, r), 0.05, gen))
            (out, occ), (want, want_occ) = (
                ops.closure_update_tiled(*upd, impl="cuda"),
                ops.closure_update_tiled(*upd, impl="ref"))
            err["closure_update_tiled"] = max(
                err["closure_update_tiled"], mismatch(out, want),
                mismatch(occ, want_occ))
            n_cases += 1
        (out, occ), (want, want_occ) = (
            ops.closure_delete_tiled(*dele, impl="cuda"),
            ops.closure_delete_tiled(*dele, impl="ref"))
        err["closure_delete_tiled"] = max(
            err["closure_delete_tiled"], mismatch(out, want),
            mismatch(occ, want_occ))
        n_cases += 1
    torch.cuda.synchronize()
    say("kernels", f"{n_cases} cases on the card (test_kernels.py shapes; "
        f"{n_b1_b3} of B1 and B3 over densities 0-100%, block-mixed, "
        f"ragged, lhs is rhs, the frontier hop, and {n_b2} of B2 over mask "
        f"densities 0-100%, block-mixed, C 320 / 1056, B 32-1024, an "
        f"all-ones closure, each by both paths; tiled "
        f"windows 32-4096, lhs rows of 0-33 and all set bits), max abs err "
        f"per kernel {err}")
    check(not any(err.values()), f"kernel disagrees with its plain "
          f"version at the test shapes: {err}")

    records = {}
    c, w = C_FULL, C_FULL // 32
    say("kernels", "library_ms = one fp16 torch.matmul of the unpacked "
        "operands: a yardstick only, the port never calls it")

    def measure(name, label, kernel_fn, plain_fn, lib_args, nbytes, ops_n,
                reps=20, plain_reps=3, lib_reps=5):
        """The kernel against its plain version, then its times and the
        yardstick's, turn for turn (kernel, library, library, kernel)."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if isinstance(got, tuple):   # the tiled kernels: (words, occ)
            e = max(mismatch(a, b) for a, b in zip(got, want))
        else:
            e = mismatch(got, want)
        del got, want
        check(e == 0.0, f"{name} disagrees with its plain version at {label}")
        library = fp16_matmul(*lib_args)
        # TURNS rounds of (kernel, library, library, kernel): the host's
        # time a call moves by tens of percent within a call, so each side
        # is the median of its turns, and each kernel turn is paired with
        # the library turn beside it
        k_turns, l_turns = [], []
        for _ in range(TURNS):
            k_turns.append(cuda_ms(kernel_fn, reps))
            l_turns += [cuda_ms(library, lib_reps), cuda_ms(library, lib_reps)]
            k_turns.append(cuda_ms(kernel_fn, reps))
        won = sum(k < lt for k, lt in zip(k_turns, l_turns))
        rec = {"ms": float(np.median(k_turns)),
               "plain_ms": cuda_ms(plain_fn, plain_reps),
               "library_ms": float(np.median(l_turns))}
        main_ms, work_ms = kernel_device_parts(kernel_fn, reps, name)
        device = main_ms + work_ms
        host, lib_host = host_ms(kernel_fn, reps), host_ms(library, lib_reps)
        del library
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops_n)
        rec["max_abs_err"] = max(e, err[name])
        say("kernels", f"{name} {label}, {TURNS} rounds turn for turn: "
            f"kernel_ms {rec['ms']:.4f} (median; turns "
            f"{' '.join(f'{x:.4f}' for x in k_turns)}), library_ms "
            f"{rec['library_ms']:.4f} (median; turns "
            f"{' '.join(f'{x:.4f}' for x in l_turns)}); kernel / library "
            f"{rec['ms'] / rec['library_ms']:.3f}, the kernel faster in "
            f"{won} of {len(k_turns)} adjacent pairs; device_ms={device:.4f} "
            f"alone{f' (first launch {work_ms:.4f})' if work_ms else ''}; "
            f"host_ms={host:.4f} a call (library {lib_host:.4f}); "
            f"plain_ms={rec['plain_ms']:.3f} bound_ms={rec['bound_ms']:.4g} "
            f"({rec['bound_by']})")
        return rec

    # B1: a closure squaring (C x C) and a frontier hop (B rows), 1% dense
    lhs, rhs = packed((c, c), 0.01, gen), packed((c, c), 0.01, gen)
    records["bitmm"] = measure(
        "bitmm", f"squaring ({c}, {w}) x ({c}, {w}), 1% dense, "
        f"{dense_share(lhs):.0%} of row blocks dense",
        lambda: ops.bitmm_packed(lhs, rhs, impl="cuda"),
        lambda: ops.bitmm_packed(lhs, rhs, impl="ref"), (lhs, rhs),
        3 * c * w * 4, 2 * popcount_total(lhs) * c)
    front = packed((B_FULL, c), 0.01, gen)
    measure("bitmm", f"frontier hop ({B_FULL}, {w}) x ({c}, {w}), 1% dense, "
            f"{dense_share(front):.0%} of row blocks dense",
            lambda: ops.bitmm_packed(front, rhs, impl="cuda"),
            lambda: ops.bitmm_packed(front, rhs, impl="ref"), (front, rhs),
            (2 * B_FULL * w + c * w) * 4, 2 * popcount_total(front) * c)
    del front
    crossover(gen)
    # B1 squaring a dense closure, B3 with every row of it affected
    closure, density = dense_closure(gen)
    measure("bitmm", f"squaring the closure ({c}, {w}), {density:.0%} "
            f"dense, {dense_share(closure):.0%} of row blocks dense",
            lambda: ops.bitmm_packed(closure, closure, impl="cuda"),
            lambda: ops.bitmm_packed(closure, closure, impl="ref"),
            (closure, closure), 2 * c * w * 4,
            2 * popcount_total(closure) * c, reps=3, plain_reps=1,
            lib_reps=3)
    every = torch.full((w,), -1, dtype=torch.int32, device="cuda")
    measure("closure_delete", f"C={c}, every row of the closure affected, "
            f"{dense_share(closure, every):.0%} of row blocks dense",
            lambda: ops.closure_delete(closure, closure, every, impl="cuda"),
            lambda: ops.closure_delete(closure, closure, every, impl="ref"),
            (closure, closure), (2 * c * w + w) * 4,
            2 * popcount_total(closure) * c, reps=3, plain_reps=1,
            lib_reps=3)
    del closure, every
    # B2: the rank-B fold at C=16384, B=1024: 1% and 50% dense masks, the
    # two paths' crossover, and the last fold of two main-path streams
    rows = packed((B_FULL, c), 0.01, gen)
    fold_bytes = (2 * c * w + c * B_FULL // 32 + B_FULL * w) * 4
    for md in (0.01, 0.5):
        mask = packed((c, B_FULL), md, gen)
        rec = measure(
            "closure_update", f"C={c} B={B_FULL}, {md:.0%} dense mask, 1% "
            f"dense rows, {dense_share(mask):.0%} of row blocks dense",
            lambda: ops.closure_update(lhs, mask, rows, impl="cuda"),
            lambda: ops.closure_update(lhs, mask, rows, impl="ref"),
            (mask, rows), fold_bytes, 2 * popcount_total(mask) * c,
            plain_reps=3 if md < 0.1 else 1)
        if md == 0.01:
            records["closure_update"] = rec
    del mask
    b2_crossover(lhs, rows, gen)
    del rows
    for profile in ("insheavy", "delheavy"):
        closure, mask, rows = captured_fold(profile)
        bits = popcount_total(mask)
        measure("closure_update", f"the last fold of the {profile} stream "
                f"(C={c}, mask {tuple(mask.shape)}: B={rows.shape[0]}), "
                f"{bits} mask bits set ({bits / mask.numel() / 32:.4%}), "
                f"{dense_share(mask):.0%} of row blocks dense",
                lambda: ops.closure_update(closure, mask, rows, impl="cuda"),
                lambda: ops.closure_update(closure, mask, rows, impl="ref"),
                (mask, rows),
                (2 * closure.numel() + mask.numel() + rows.numel()) * 4,
                2 * bits * c)
        del closure, mask, rows
    # B3: one repair hop at C=16384, 1% and 25% of the rows affected
    from repro_torch.core import bitset
    for frac in (0.01, 0.25):
        aff = packed((c,), frac, gen)
        aff_rows = bitset.unpack_bits(aff)
        rec = measure(
            "closure_delete", f"C={c}, {frac:.0%} rows affected, 1% dense, "
            f"{dense_share(lhs, aff):.0%} of row blocks dense",
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
        2 * popcount_total(mask) * r, reps=1000, plain_reps=20,
        lib_reps=1000)
    for frac in (0.01, 0.25):
        aff = packed((r,), frac, gen)
        aff_rows = bitset.unpack_bits(aff)
        rec = measure(
            "closure_delete_tiled", f"R={r}, {frac:.0%} rows affected, "
            "1% dense",
            lambda: ops.closure_delete_tiled(tiles, s, aff, impl="cuda"),
            lambda: ops.closure_delete_tiled(tiles, s, aff, impl="ref"),
            (tiles, s), (3 * r * wr + wr + (r // 32) * wr) * 4,
            2 * popcount_total(tiles[aff_rows]) * r, reps=1000,
            plain_reps=20, lib_reps=1000)
        if frac == 0.01:
            records["closure_delete_tiled"] = rec
    del tiles, s, mask, rows
    # where B5's device time goes at R = 1024, 10 set bits an affected
    # row: one row affected (one warp gathers), one band (one block's 32
    # warps), every row (32 blocks on 32 SMs).  Equal times mean one
    # warp's chain of gathers sets the time, and neither an SM's
    # throughput nor the number of SMs at work does
    lhs10, s10 = (exact_bit_rows((10,), r, r, gen),
                  packed((r, r), 0.01, gen))
    spread = {}
    for label, n_aff in (("one row", 1), ("one band", 32), ("every row", r)):
        aff = torch.zeros((r,), dtype=torch.bool, device="cuda")
        aff[:n_aff] = True
        aff = bitset.pack_bits(aff)
        spread[label] = kernel_device_ms(
            lambda: ops.closure_delete_tiled(lhs10, s10, aff, impl="cuda"),
            200, "closure_delete_tiled")
    say("kernels", f"closure_delete_tiled R={r}, 10 set bits an affected "
        "row, device_ms by rows affected: " + ", ".join(
            f"{k} {v:.4f}" for k, v in spread.items()))
    del lhs10, s10
    # the host side of a B5 call at the main path's shape, step by step
    tiles, s = packed((r, r), 0.01, gen), packed((r, r), 0.01, gen)
    aff = packed((r,), 0.01, gen)
    alloc = allocation_turns(tiles)
    say("kernels", f"allocating out ({r}, {wr}) and occ ({r // 32}, {wr}), "
        "host us a call, turn for turn: " + ", ".join(
            f"{k} {v:.3f}" for k, v in alloc.items()))
    steps = launch_path_steps(tiles, s, aff)
    say("kernels", "closure_delete_tiled R=1024, 1% rows affected, host us "
        "a call by step: " + "; ".join(f"{k} {v:.3f}"
                                       for k, v in steps.items()))
    del tiles, s, aff
    records["flash_attention"] = flash_attention_records(gen)
    torch.cuda.empty_cache()
    records["embbag"] = embbag_records()
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
        ((1, 6, 1, 200, 2049, 32), True, (bf16, f16)),   # d = 32, Tk 2049
        ((1, 3, 1, 257, 1000, 16), False, (bf16,)),      # group 3, Tk 1000
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
    # the plain version with 64 keys left out stands in for a kernel that
    # skipped them (half of one of B7's 128-key tiles: a smaller fault
    # than a skipped tile)
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

    # timings at the LM prefill's shape: B7 and SDPA turn for turn in this
    # call (kernel, SDPA, SDPA, kernel)
    kx = k.repeat_interleave(hq // hkv, dim=1)
    vx = v.repeat_interleave(hq // hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kern():
        return ops.flash_attention(q, k, v, impl="cuda")

    def library():
        return sdpa(q, kx, vx, is_causal=True)

    turns = [cuda_ms(fn, 20) for fn in (kern, library, library, kern)]
    rec = {"ms": (turns[0] + turns[3]) / 2,
           "plain_ms": cuda_ms(lambda: ops.flash_attention(q, k, v,
                                                           impl="ref"), 3),
           "library_ms": (turns[1] + turns[2]) / 2,
           "max_abs_err": worst[bf16]}
    device = kernel_device_ms(kern, 20, "flash_attention")
    library_device = device_ms_per_call(library, 20)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 2 * 2 * b * hq * d * causal_pairs(t, t, True)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, BF16_FLOP_PER_S)
    say("kernels", f"flash_attention ({b}, {hq}, {t}, {d}) over {hkv} KV "
        f"heads, bf16, causal, turn for turn: kernel_ms {turns[0]:.4f}, "
        f"SDPA {turns[1]:.4f}, SDPA {turns[2]:.4f}, kernel_ms "
        f"{turns[3]:.4f}; kernel / SDPA {rec['ms'] / rec['library_ms']:.3f}"
        f"; device_ms={device:.4f} alone ({flops / device / 1e9:.1f} "
        f"TFLOP/s, {device / rec['bound_ms']:.2f}x the bound; SDPA's "
        f"kernels {library_device:.4f} ms a call) plain_ms="
        f"{rec['plain_ms']:.3f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}: {flops:.4g} flop, {nbytes} bytes) "
        f"library_ms={rec['library_ms']:.4f} (one scaled_dot_product_"
        "attention call, K/V expanded to Hq: a yardstick only, the port "
        "never calls it)")
    # the same turns at shapes off the main path: a yardstick for the
    # open questions (PERF.md section 7), not a check
    for shape, causal in (((b, hq, hkv, t, t, d), False),
                          ((b, hq, hkv, t, t, 64), True),
                          ((1, 16, 16, 8192, 8192, 128), True)):
        q2, k2, v2 = qkv(*shape, bf16)
        g = shape[1] // shape[2]
        kx2, vx2 = (x.repeat_interleave(g, dim=1) for x in (k2, v2))
        fl = 2 * 2 * shape[0] * shape[1] * shape[5] * causal_pairs(
            shape[3], shape[4], causal)
        fns = (lambda: ops.flash_attention(q2, k2, v2, causal=causal,
                                           impl="cuda"),
               lambda: sdpa(q2, kx2, vx2, is_causal=causal))
        ms = [cuda_ms(fns[i], 10) for i in (0, 1, 1, 0)]
        kms, lms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        say("kernels", f"flash_attention {shape} causal={causal} bf16, turn "
            f"for turn: kernel_ms {kms:.4f} ({fl / kms / 1e9:.1f} TFLOP/s), "
            f"SDPA {lms:.4f} ({fl / lms / 1e9:.1f}), kernel / SDPA "
            f"{kms / lms:.3f}")
        del q2, k2, v2, kx2, vx2
    ptx = PTXAS.get("flash_attention<13__nv_bfloat16, d=128>", {})
    say("kernels", f"flash_attention<bf16, d=128> (ptxas -v): "
        f"{ptx.get('registers')} registers a thread at launch (384 "
        f"threads; setmaxnreg gives the consumers 240, the producer 24), "
        f"{ptx.get('static_smem')} bytes static and {B7_SMEM[128]} bytes "
        f"dynamic shared memory, {ptx.get('spills', 'spills not reported')}")
    return rec


def embbag_error(got, want, table, idx, w):
    """(max abs error, max of the error over its bound EMB_TOL) of B6's
    output ``got`` against the plain version's ``want`` on the inputs."""
    mag = (table[idx.long()].float().abs()
           * w.abs()[..., None]).sum(1)                 # sum_k |w_k t_k|
    tol = idx.shape[1] * EMB_ULP_F32 * mag
    if table.dtype == torch.bfloat16:
        tol += EMB_ULP_BF16 * want.float().abs()
    err = (got.float() - want.float()).abs()
    return (float(err.max()) if err.numel() else 0.0,
            float((err / tol.clamp(min=1e-30)).max()) if err.numel() else 0.0)


def embbag_inputs(rows, d, b, k, dtype, gen, *, unit=False, idx=None):
    """A table (R, D) ~ N(0, 1) in ``dtype``, idx (B, K) uniform over the
    rows (or ``idx``), weights U(0, 1) with ~20% 0-weight padding (or all
    1), on the card from ``gen``."""
    table = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    if idx is None:
        idx = torch.randint(0, rows, (b, k), generator=gen, device="cuda",
                            dtype=torch.int32)
    if unit:
        w = torch.ones((b, k), device="cuda")
    else:
        w = torch.rand((b, k), generator=gen, device="cuda") * (
            torch.rand((b, k), generator=gen, device="cuda") < 0.8)
    return table, idx, w


def xdeepfm_ids(batch: int, rng) -> torch.Tensor:
    """(batch, 39) per-field ids, each drawn uniformly within its field's
    vocabulary of configs/xdeepfm.py (numpy), on the card."""
    from repro_torch.configs import xdeepfm

    return torch.from_numpy(np.stack(
        [rng.integers(0, v, batch) for v in xdeepfm.CFG.vocab_sizes], 1)
        .astype(np.int32)).cuda()


def embbag_records():
    """B6 against its plain version over the sweep, the dropped-term
    check, then its timings at the xDeepFM main path's shape and at
    kernel_bench's; returns the main path's record."""
    from repro_torch.configs import xdeepfm
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import embedding as emb

    gen = torch.Generator(device="cuda").manual_seed(6)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (R, D, B, K), types
        ((64, 16, 8, 4), (f32, bf16)), ((256, 128, 16, 8), (f32, bf16)),
        ((1024, 32, 32, 2), (f32, bf16)),                # test_kernels.py
        ((300, 3, 7, 5), (f32, bf16)), ((64, 40, 9, 33), (f32, bf16)),
        ((64, 1100, 4, 5), (f32,)), ((64, 2056, 3, 5), (bf16,)),
        ((16, 8, 0, 3), (f32,)),                         # ragged, B = 0
    ]
    # both paths (rows of <= 16 bytes split the k loop across lanes):
    # K from one lane group of 1 to 32 lanes past 32 and past a lane's 8
    # gathers, D across both paths, B from one bag to many blocks
    cases += [((300, d, b, k), (f32, bf16))
              for k in (1, 2, 31, 32, 33, 39, 64, 100)
              for d in (1, 2, 3, 4, 8) for b in (1, 7, 512)]
    worst = {f32: 0.0, bf16: 0.0}
    ratio = {f32: 0.0, bf16: 0.0}
    n = 0
    for shape, dtypes in cases:
        for dt in dtypes:
            table, idx, w = embbag_inputs(*shape, dt, gen)
            got = ops.embedding_bag(table, idx, w, impl="cuda")
            want = ops.embedding_bag(table, idx, w, impl="ref")
            torch.cuda.synchronize()
            check(got.dtype == dt and got.shape == want.shape,
                  f"embbag {shape}: output {got.dtype} {tuple(got.shape)}")
            e, r = embbag_error(got, want, table, idx, w)
            worst[dt], ratio[dt] = max(worst[dt], e), max(ratio[dt], r)
            check(r <= 1, f"embbag {shape} {dt}: error {r:.3g} times its "
                  f"bound (max abs err {e})")
            n += 1

    # the main path's shape: the xDeepFM linear term at serve_p99
    cfg = xdeepfm.CFG
    rows, b = cfg.total_rows(), xdeepfm.SHAPES["serve_p99"]["batch"]
    offsets = torch.from_numpy(emb.field_offsets(cfg.vocab_sizes)).cuda()
    main_idx = emb.flat_ids(xdeepfm_ids(b, np.random.default_rng(6)), offsets)
    k = main_idx.shape[1]
    main = embbag_inputs(rows, 1, b, k, f32, gen, unit=True, idx=main_idx)
    bench = embbag_inputs(1_000_000, 64, 4096, 4, f32, gen, unit=True)
    for label, (table, idx, w) in (("main", main), ("kernel_bench", bench)):
        got = ops.embedding_bag(table, idx, w, impl="cuda")
        want = ops.embedding_bag(table, idx, w, impl="ref")
        torch.cuda.synchronize()
        e, r = embbag_error(got, want, table, idx, w)
        worst[f32], ratio[f32] = max(worst[f32], e), max(ratio[f32], r)
        check(r <= 1, f"embbag at the {label} shape: error {r:.3g} times its "
              f"bound (max abs err {e})")
        n += 1
    say("kernels", f"embbag: {n} cases on the card, max abs err per type "
        f"{{f32: {worst[f32]:.3g}, bf16: {worst[bf16]:.3g}}}, largest error "
        f"over its bound {{f32: {ratio[f32]:.3g}, bf16: {ratio[bf16]:.3g}}} "
        "(bound per element: K 2^-23 sum_k |w_k t_k|, plus 2^-7 |want| in "
        "bf16; both sum float32 products in float32)")

    # the bound must see a bag with its first term left out
    table, idx, w = main
    want = ops.embedding_bag(table, idx, w, impl="ref")
    dropped = ops.embedding_bag(table, idx[:, 1:].contiguous(),
                                w[:, 1:].contiguous(), impl="ref")
    e, r = embbag_error(dropped, want, table, idx, w)
    check(r > 1, f"embbag: the bound does not reject an output with term "
          f"k=0 left out ({r:.3g} of it)")
    say("kernels", f"embbag: with term k=0 left out of every bag at the main "
        f"shape, the error is {r:.3g} times its bound (max abs err "
        f"{e:.3g}): rejected")
    del want, dropped

    records = {}
    for label, (table, idx, w) in (
            (f"xDeepFM linear term R={rows} D=1 B={b} K={k}, unit weights",
             main),
            ("kernel_bench R=1000000 D=64 B=4096 K=4, unit weights", bench)):
        bb, kk = idx.shape
        d = table.shape[1]

        def kern():
            return ops.embedding_bag(table, idx, w, impl="cuda")

        rec = {"ms": cuda_ms(kern, 200),
               "plain_ms": cuda_ms(lambda: ops.embedding_bag(
                   table, idx, w, impl="ref"), 20),
               "library_ms": cuda_ms(
                   lambda: torch.nn.functional.embedding_bag(
                       idx, table, per_sample_weights=w, mode="sum"), 200),
               "max_abs_err": worst[f32]}
        device = kernel_device_ms(kern, 200, "embbag")
        path = ("k split across lanes" if any(
            "embbag_kernel_ksplit" in e.key for e in profiled(kern, 1))
            else "a thread a chunk")
        nbytes = 4 * (bb * kk * d + 2 * bb * kk + bb * d)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * bb * kk * d,
                                                 F32_FLOP_PER_S)
        say("kernels", f"embbag {label}, f32, path {path}: kernel_ms="
            f"{rec['ms']:.4f} (device_ms={device:.4f} alone) plain_ms="
            f"{rec['plain_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}: {nbytes} "
            f"bytes) library_ms={rec['library_ms']:.4f} (one "
            "F.embedding_bag(mode='sum') call: a yardstick only, the port "
            "never calls it)")
        records.setdefault("embbag", rec)
    return records["embbag"]


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
    recsys_parity()


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
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
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


def recsys_parity():
    """xDeepFM at the reduced config of tests/test_recsys.py in float32 on
    the card (B6 in its linear term) and on the CPU, from the same params
    (one seeded init) and ids: forward, loss and retrieval scores."""
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import xdeepfm as X

    cfg = X.XDeepFMConfig(
        name="t", n_fields=6, embed_dim=8, cin_layers=(16, 16),
        mlp_dims=(32, 32), vocab_sizes=(16, 32, 8, 64, 16, 8), n_items=128,
        retrieval_dim=16)
    params = X.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, 16)
                                     for v in cfg.vocab_sizes], 1)
                           .astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, 2, 16))
    cand = torch.arange(cfg.n_items)
    runs = {}
    before = ops.LAUNCHES["embbag"]
    for d in ("cuda", "cpu"):
        on = {k: ([tuple(x.to(d) for x in v) if isinstance(v, tuple)
                   else v.to(d) for v in p] if isinstance(p, list)
                  else p.to(d))
              for k, p in params.items()}
        i = ids.to(d)
        runs[d] = (X.forward(cfg, on, i),
                   X.loss(cfg, on, {"ids": i, "labels": labels.to(d)}),
                   X.retrieval_score(cfg, on, i[:1], cand.to(d)))
    torch.cuda.synchronize()
    check(ops.LAUNCHES["embbag"] - before == 2,
          "recsys parity: the card's forward and loss did not each launch "
          "B6 once")
    err = {name: float((c.cpu() - h).abs().max()) for name, c, h in zip(
        ("forward", "loss", "retrieval_score"), runs["cuda"], runs["cpu"])}
    for name, e in err.items():
        check(e <= 1e-5, f"recsys parity: {name} differs card vs CPU by {e}")
    say("parity", f"xDeepFM at the reduced config of tests/test_recsys.py, "
        f"float32, batch 16, {cfg.n_items} candidates: max abs diff card vs "
        f"CPU {err} (<= 1e-5)")


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


# ------------------------------------------------------------- 7. recsys

def phase_recsys():
    """Full-width xDeepFM: serve_p99 (a warm-up, then REC_STEPS timed
    forward calls with the counters zeroed just before them), then
    retrieval_cand; then one profiled forward for B6's share of it, and
    one profiled query.  Returns the counted run's launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import xdeepfm
    from repro_torch.launch.profile_ticks import _device_us
    from repro_torch.models.recsys import xdeepfm as X

    cfg = xdeepfm.CFG
    b = xdeepfm.SHAPES["serve_p99"]["batch"]
    n_cand = xdeepfm.SHAPES["retrieval_cand"]["n_candidates"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = X.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    rng = np.random.default_rng(0)
    X.forward(cfg, params, xdeepfm_ids(b, rng))            # warm-up
    batches = [xdeepfm_ids(b, rng) for _ in range(REC_STEPS)]
    torch.cuda.synchronize()

    def serve():
        logits, times = [], []
        for ids in batches:
            t1 = time.perf_counter()
            logits.append(X.forward(cfg, params, ids))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        return logits, times

    (logits, times), launches = _launches_of(serve)
    ms = float(np.median(times))
    say("recsys", f"xDeepFM full width ({cfg.n_fields} fields, embed "
        f"{cfg.embed_dim}, CIN {cfg.cin_layers}, MLP {cfg.mlp_dims}, "
        f"{cfg.total_rows()} table rows, {cfg.n_items} items x "
        f"{cfg.retrieval_dim}, float32; params on the card in {init_s:.1f}s, "
        f"{resident / 2**20:.0f} MiB): serve_p99 batch {b}, {REC_STEPS} "
        f"forward calls: median {ms:.4f} ms, mean {np.mean(times):.4f} ms, "
        f"max {max(times):.4f} ms per batch, {b / ms * 1e3:.0f} samples/s "
        f"(median), launches {launches}")
    check(launches["embbag"] == REC_STEPS,
          f"serve_p99 launched B6 {launches['embbag']} times in "
          f"{REC_STEPS} forward calls, not once per call")
    check(all(v == 0 for k, v in launches.items() if k != "embbag"),
          f"the recsys path launched another kernel: {launches}")
    for out in logits:
        check(tuple(out.shape) == (b,) and bool(torch.isfinite(out).all()),
              f"serve_p99: logits {tuple(out.shape)} not finite")

    # retrieval_cand: one query against every candidate
    query = xdeepfm_ids(1, rng)
    cand = torch.arange(n_cand, device="cuda")
    scores = X.retrieval_score(cfg, params, query, cand)
    torch.cuda.synchronize()
    times = []
    for _ in range(REC_STEPS):
        t1 = time.perf_counter()
        scores = X.retrieval_score(cfg, params, query, cand)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    check(tuple(scores.shape) == (n_cand,)
          and bool(torch.isfinite(scores).all()),
          f"retrieval_cand: scores {tuple(scores.shape)} not finite")
    say("recsys", f"retrieval_cand: one query against {n_cand} candidates: "
        f"median {np.median(times):.4f} ms, max {max(times):.4f} ms over "
        f"{REC_STEPS} calls; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    # one profiled forward (B6's share of its device time) and one
    # profiled query, outside the counted run
    for label, call in (
            (f"forward at batch {b}", lambda: X.forward(cfg, params,
                                                        batches[0])),
            ("retrieval_cand query", lambda: X.retrieval_score(
                cfg, params, query, cand))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        events = [(e.key, _device_us(e), e.count)
                  for e in prof.key_averages() if _device_us(e) > 0]
        busy = sum(us for _, us, _ in events)
        bag = sum(us for k, us, _ in events if "embbag_kernel" in k)
        top = sorted(events, key=lambda e: -e[1])[:6]
        say("recsys", f"one profiled {label}: wall {wall:.3f} ms (profiler "
            f"on), device busy {busy / 1e3:.4f} ms, idle share "
            f"{1 - busy / 1e3 / wall:.3f}, {sum(n for _, _, n in events)} "
            f"device operations, B6 {bag / 1e3:.4f} ms "
            f"({bag / max(busy, 1e-9):.1%}); top kernels "
            + "; ".join(f"{k[:60]} {us / 1e3:.4f} ms x{n}"
                        for k, us, n in top))
    return launches


# -------------------------------------------------------- 8. replication

REP_TICKS = 10                  # ticks of each replicated stream
REP_REPLICAS = 2
FE_BATCH, FE_WAIT_S = 64, 0.002   # benchmarks/openloop.py (run_openloop's)
FE_DURATION_S = 4.0             # ~10 ticks at 25% of the saturated rate
CHAOS_C, CHAOS_B, CHAOS_TICKS, CHAOS_SEED = 2048, 256, 10, 11
REPLAY_KERNELS = ("closure_update", "closure_delete", "closure_update_tiled",
                  "closure_delete_tiled")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _profiled_call(fn, device: str = "cuda") -> dict:
    """One call of ``fn`` under torch.profiler: wall ms (profiler on),
    device-busy ms, kernel launches, copies and the device kernels with
    the most launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_ticks import _device_us

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_us(e) for e in on_device) / 1e3
    top = sorted(on_device, key=lambda e: -e.count)[:4]
    return {"wall_ms": wall, "busy_ms": busy,
            "launches": sum(e.count for e in events
                            if e.key == "cudaLaunchKernel"),
            "copies": sum(e.count for e in events
                          if e.key in ("cudaMemcpyAsync", "cudaMemcpy")),
            "top": "; ".join(f"{e.key[:40]} x{e.count}" for e in top)}


def _profile_line(r: dict) -> str:
    return (f"wall {r['wall_ms']:.3f} ms (profiler on), device busy "
            f"{r['busy_ms']:.3f} ms, idle share "
            f"{1 - r['busy_ms'] / r['wall_ms']:.3f}, {r['launches']} kernel "
            f"launches, {r['copies']} copies; most launched: {r['top']}")


def _new_entries(p, cursor: int):
    """(the log entries ``p`` shipped since ``cursor``, the new cursor),
    after flushing what is staged."""
    p.flush()
    return p.log[cursor:], len(p.log)


def _same_entries(a, b, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} log entries")
    for x, y in zip(a, b):
        check((x.epoch, x.grow_to, x.prev_epoch, x.crc)
              == (y.epoch, y.grow_to, y.prev_epoch, y.crc),
              f"{what}: log entry ({x.epoch}, {x.crc:#010x}) vs "
              f"({y.epoch}, {y.crc:#010x})")
        for f, u, v in zip(type(x.delta)._fields, x.delta, y.delta):
            check(u.dtype == v.dtype and np.array_equal(u, v),
                  f"{what}: epoch {x.epoch} delta.{f} differs")


def replication_parity(capacity: int = C_PARITY, batch: int = B_PARITY,
                       ticks: int = T_PARITY, device: str = "cuda") -> None:
    """(a) The writer's log on ``device`` equals the CPU's entry for entry,
    CRC for CRC (eager and defer_flush + jit; the delheavy and steady
    streams), and two replicas on ``device`` replay it to the CPU writer's
    adjacency and closure, bit for bit."""
    from repro_torch.core import closure_cache
    from repro_torch.launch import serve
    from repro_torch.replica import Primary, Replica

    streams = {
        "delheavy": (serve.primary_churn_tick, "incremental",
                     serve._sgt_churn_inputs(capacity, batch, ticks, 0,
                                             "delheavy")),
        "steady": (serve.primary_steady_tick, "auto",
                   serve._sgt_tick_inputs(capacity, batch, ticks, 0))}
    for name, (tick, method, inputs) in streams.items():
        for mode, opts in (("eager", {}),
                           ("defer_flush+jit", {"defer_flush": True,
                                                "jit": True})):
            prims = {d: Primary.create(capacity, method=method, device=d,
                                       **opts) for d in (device, "cpu")}
            reps = [Replica.from_engine(prims[device].engine)
                    for _ in range(REP_REPLICAS)]
            cursors = {d: 0 for d in prims}
            t0 = time.perf_counter()
            for xs in inputs:
                new = {}
                for d, p in prims.items():
                    tick(p, serve.on_device(d, xs))
                    new[d], cursors[d] = _new_entries(p, cursors[d])
                _same_entries(new[device], new["cpu"], f"{name} {mode}")
                reps = [r.replay(new[device]) for r in reps]
            host = prims["cpu"].engine.refresh_cache()
            for r in reps:
                check(r.epoch == host.epoch, f"{name} {mode}: replica epoch")
                check(torch.equal(r.adj.cpu(), host.state.adj)
                      and torch.equal(
                          closure_cache.dense_of(r.closure).cpu(),
                          closure_cache.dense_of(host.cache.closure)),
                      f"{name} {mode}: a replica on the card differs from "
                      "the CPU writer")
                check(r.converged_with(prims[device].engine),
                      f"{name} {mode}: a replica did not converge")
            say("replication", f"(a) {name} {mode}: {len(prims[device].log)} "
                f"log entries at C={capacity} B={batch} identical on the "
                f"card and the CPU, CRC for CRC; {REP_REPLICAS} replicas on "
                f"the card equal the CPU writer's adjacency and closure "
                f"(epoch {host.epoch}, {time.perf_counter() - t0:.1f}s)")


def replicated_run(tick, inputs, capacity: int, method: str, device: str,
                   ckpt_dir=None, ckpt_at=None, **layout) -> dict:
    """A ``Primary(defer_flush=True, jit=True)`` writer on ``device`` over
    ``inputs``, with ``REP_REPLICAS`` replicas replaying each tick's
    entries.  Returns the writer, the replicas, per-entry replay times
    and the replay's launches (a snapshot diff of the counters around
    each replay).  With ``ckpt_dir`` the writer checkpoints after tick
    ``ckpt_at``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.replica import Primary, Replica

    p = Primary.create(capacity, method=method, device=device,
                       defer_flush=True, jit=True, **layout)
    reps = [Replica.from_engine(p.engine) for _ in range(REP_REPLICAS)]
    replay_launches = {k: 0 for k in REPLAY_KERNELS}
    writer_s, replay_s, n_entries, ckpt_s, cursor = [], [], 0, None, 0
    for t, xs in enumerate(inputs):
        t0 = time.perf_counter()
        tick(p, serve.on_device(device, xs))
        new, cursor = _new_entries(p, cursor)
        _sync(device)
        writer_s.append(time.perf_counter() - t0)
        before_tick = reps[0]
        for i in range(len(reps)):
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            reps[i] = reps[i].replay(new)
            _sync(device)
            replay_s.append(time.perf_counter() - t0)
            for k in replay_launches:
                replay_launches[k] += ops.LAUNCHES[k] - before[k]
        n_entries += len(new)
        last = (before_tick, new)
        if ckpt_dir is not None and t == ckpt_at:
            t0 = time.perf_counter()
            p.checkpoint(ckpt_dir)
            ckpt_s = time.perf_counter() - t0
    # the last tick's replay once more (replicas are immutable: the same
    # work from the same state), under the profiler, outside the counts
    rep0, entries = last
    counts = dict(ops.LAUNCHES)
    prof = _profiled_call(lambda: rep0.replay(entries), device)
    ops.LAUNCHES.update(counts)
    return {"primary": p, "replicas": reps, "writer_s": writer_s,
            "replay_s": replay_s, "entries": n_entries,
            "replay_launches": replay_launches, "ckpt_s": ckpt_s,
            "replay_profile": prof, "last_entries": len(entries)}


def replication_dense(capacity: int = C_FULL, batch: int = B_FULL,
                      ticks: int = REP_TICKS, device: str = "cuda",
                      reads: int = 512):
    """(b) The dense main path's steady and delheavy streams through a
    replicated writer; the snapshot reads of `serve_sgt_replicated`; a
    checkpoint + log tail recovered bit for bit.  Returns the replay's
    launches."""
    import os
    import tempfile

    from repro_torch.core.engine import DagEngine
    from repro_torch.launch import serve
    from repro_torch.replica import (load_delta_log, recover_replica,
                                     save_delta_log)

    total = {k: 0 for k in REPLAY_KERNELS}
    runs = {"steady": (serve.primary_steady_tick,
                       serve._sgt_tick_inputs(capacity, batch, ticks, 0)),
            "delheavy": (serve.primary_churn_tick,
                         serve._sgt_churn_inputs(capacity, batch, ticks, 0,
                                                 "delheavy"))}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        for name, (tick, inputs) in runs.items():
            ckpt_dir = os.path.join(tmp, name)
            t0 = time.perf_counter()
            run, launches = _launches_of(lambda: replicated_run(
                tick, inputs, capacity, "auto", device, ckpt_dir=ckpt_dir,
                ckpt_at=ticks // 2 - 1))
            p, reps = run["primary"], run["replicas"]
            for k in total:
                total[k] += run["replay_launches"][k]
            for r in reps:
                check(r.converged_with(p.engine),
                      f"dense {name}: a replica did not converge")
            per_entry = sum(run["replay_s"]) * 1e3 / (
                run["entries"] * len(reps))
            rep_bytes = sum(x.numel() * x.element_size()
                            for x in (reps[0].adj, reps[0].closure))
            say("replication", f"(b) dense {name} C={capacity} B={batch}, "
                f"{ticks} ticks: writer median tick "
                f"{np.median(run['writer_s']) * 1e3:.3f} ms (defer_flush + "
                f"jit, flush included); {run['entries']} entries, replay "
                f"{per_entry:.3f} ms an entry a replica (median tick a "
                f"replica {np.median(run['replay_s']) * 1e3:.3f} ms); "
                f"{len(reps)} replicas of {rep_bytes / 2**20:.0f} MiB each "
                f"converged; replay launches {run['replay_launches']}; the "
                f"whole run's launches {launches} "
                f"({time.perf_counter() - t0:.1f}s)")
            say("replication", f"(b) dense {name}: one profiled replay of "
                f"the last tick's {run['last_entries']} entries: "
                + _profile_line(run["replay_profile"]))
            check(run["replay_launches"]["closure_update"] > 0,
                  f"dense {name}: the replay never launched B2")
            if name == "delheavy":
                check(run["replay_launches"]["closure_delete"] > 0,
                      "dense delheavy: the replay never launched B3")
            # the checkpoint (taken mid-run) + the whole log -> recovery
            log_path = os.path.join(tmp, f"{name}.log")
            t0 = time.perf_counter()
            save_delta_log(log_path, p.log)
            save_ms = (time.perf_counter() - t0) * 1e3
            like = DagEngine.create(capacity, method="auto", device=device)
            t0 = time.perf_counter()
            rec = recover_replica(ckpt_dir, like, load_delta_log(log_path))
            _sync(device)
            rec_ms = (time.perf_counter() - t0) * 1e3
            check(rec.converged_with(p.engine),
                  f"dense {name}: recovery did not converge")
            step = os.listdir(ckpt_dir)[0]
            ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, step,
                                                      "arrays.npz"))
            say("replication", f"(b) dense {name}: checkpoint after tick "
                f"{ticks // 2} ({step}, {ckpt_bytes} bytes) "
                f"{run['ckpt_s'] * 1e3:.1f} ms; save_delta_log of "
                f"{len(p.log)} entries ({os.path.getsize(log_path)} bytes) "
                f"{save_ms:.1f} ms; recover_replica (restore + replay of the "
                f"tail) {rec_ms:.1f} ms, converged bit for bit")
            del run, p, reps, rec
    for r in (0, REP_REPLICAS):
        out = serve.serve_sgt_replicated(capacity=capacity, batch=batch,
                                         ticks=ticks, replicas=r,
                                         reads=reads, device=device)
        check(r == 0 or out["row_products"] == 0,
              "snapshot reads did row products")
        say("replication", f"(b) serve_sgt_replicated C={capacity} "
            f"B={batch} replicas={r}: {out['ops_per_s']:.0f} reads/s "
            f"(median tick of {reads * max(1, r)} reads), best "
            f"{out['best_ops_per_s']:.0f}, row_products="
            f"{out['row_products']}")
    return total


def replication_tiled(capacity: int = C_TILED, batch: int = B_TILED,
                      ticks: int = T_TILED, device: str = "cuda",
                      n_reads: int = 1024):
    """(c) The tiled main path's mixed churn stream through a replicated
    writer; replicas replay through B4 / B5, converge, and read like the
    engine.  Returns the replay's launches."""
    from repro_torch.core import closure_cache
    from repro_torch.core import dag as dag_mod
    from repro_torch.launch import serve

    inputs = serve._sgt_churn_inputs(capacity, batch, ticks, 0, "mixed")
    t0 = time.perf_counter()
    run, launches = _launches_of(lambda: replicated_run(
        serve.primary_churn_tick, inputs, capacity, "incremental", device,
        closure_layout="tiled"))
    p, reps = run["primary"], run["replicas"]
    eng = p.engine
    for r in reps:
        check(r.converged_with(eng),
              f"tiled C={capacity}: a replica did not converge")
    live = eng.state.keys[eng.state.alive].cpu().numpy()
    gen = np.random.default_rng(1)
    pool = live if live.size else np.arange(capacity, dtype=np.int32)
    fk, tk = (torch.as_tensor(gen.choice(pool, n_reads), dtype=torch.int32,
                              device=device) for _ in range(2))
    want = eng.reachable(fk, tk)
    fs, ff = dag_mod.lookup_slots(eng.state, fk)
    ts, tf = dag_mod.lookup_slots(eng.state, tk)
    for r in reps:
        check(torch.equal(r.reachable_slots(fs, ts) & ff & tf, want),
              f"tiled C={capacity}: replica reads differ from the engine's")
    per_entry = sum(run["replay_s"]) * 1e3 / (run["entries"] * len(reps))
    rep_bytes = reps[0].adj.numel() * 4 + closure_cache.closure_nbytes(
        reps[0].closure)
    say("replication", f"(c) tiled mixed C={capacity} B={batch}, {ticks} "
        f"ticks: writer median tick {np.median(run['writer_s']) * 1e3:.3f} "
        f"ms; {run['entries']} entries, replay {per_entry:.3f} ms an entry "
        f"a replica; window {reps[0].closure.region}; {len(reps)} replicas "
        f"of {rep_bytes} bytes each converged, {n_reads} reads equal the "
        f"engine's "
        f"({int(want.sum())} hits); replay launches "
        f"{run['replay_launches']}; the whole run's launches {launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    say("replication", f"(c) tiled: one profiled replay of the last "
        f"tick's {run['last_entries']} entries: "
        + _profile_line(run["replay_profile"]))
    check(run["replay_launches"]["closure_update_tiled"] > 0
          and run["replay_launches"]["closure_delete_tiled"] > 0,
          f"the tiled replay did not launch B4 and B5: "
          f"{run['replay_launches']}")
    return dict(run["replay_launches"])


def replication_chaos(device: str = "cuda", plans=None) -> None:
    """(d) `serve_chaos` on every named plan at seed 11, on the card and on
    the CPU: no wrong answer, the same counters."""
    import tempfile

    from repro_torch.ft.faults import NAMED_PLANS
    from repro_torch.launch import serve

    for plan in plans or sorted(NAMED_PLANS):
        outs = {}
        for d in (device, "cpu"):
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as w:
                outs[d] = serve.serve_chaos(
                    capacity=CHAOS_C, batch=CHAOS_B, ticks=CHAOS_TICKS,
                    fault_seed=CHAOS_SEED, fault_plan=plan, replicas=2,
                    seed=CHAOS_SEED, workdir=w, device=d)
            outs[d]["s"] = time.perf_counter() - t0
        s = {d: outs[d].pop("s") for d in outs}
        check(outs[device]["wrong_answers"] == 0,
              f"chaos {plan}: wrong answers on the card")
        check(outs[device] == outs["cpu"],
              f"chaos {plan}: card {outs[device]} vs CPU {outs['cpu']}")
        say("replication", f"(d) chaos {plan} seed {CHAOS_SEED} "
            f"C={CHAOS_C} B={CHAOS_B}: {outs[device]} on the card equals "
            f"the CPU's ({s[device]:.1f}s card, {s['cpu']:.1f}s CPU)")


def _frontend_burst_rate(capacity: int, device: str, n: int):
    """(requests/s of the front-end when every tick is full, the
    front-end): ``n`` requests of the open-loop mix queued at once."""
    import asyncio

    from repro_torch.serve import Frontend, FrontendConfig
    from repro_torch.serve.openloop import request_stream

    fe = Frontend.create(capacity, FrontendConfig(
        batch_size=FE_BATCH, max_wait_s=FE_WAIT_S), device=device)
    fe.warmup()
    reqs = request_stream(n, 1, key_hi=capacity // 2)

    async def go():
        async with fe:
            await asyncio.gather(*[fe.submit(k, a, b, tenant=t)
                                   for k, a, b, t in reqs])

    t0 = time.perf_counter()
    asyncio.run(go())
    return n / (time.perf_counter() - t0), fe


def replication_frontend(capacity: int = C_FULL, device: str = "cuda",
                         duration: float = FE_DURATION_S) -> None:
    """(e) `serve_frontend` with `benchmarks/openloop.py`'s batch, wait and
    replicas at the dense capacity: the saturated rate measured first
    (every tick full), then the snapshot and the replica reader at 25% and
    80% of it; one profiled front-end tick (launches, device busy)."""
    from repro_torch.launch import serve
    from repro_torch.serve import Request
    from repro_torch.serve.openloop import request_stream

    rate, fe = _frontend_burst_rate(capacity, device, 16 * FE_BATCH)
    say("replication", f"(e) front-end C={capacity} batch {FE_BATCH}: "
        f"{rate:.0f} requests/s with every tick full "
        f"({fe.stats['ticks']} ticks of {FE_BATCH}); subbatches="
        f"{fe.primary.engine.config.subbatches}")
    # one profiled tick of a full batch of the open-loop mix; then the
    # same tick from the same state with subbatches=1 (the paper's
    # joint-abort mode: not the front end's semantics, for its cost only)
    batch = [Request(k, a, b, t, None, 0.0) for k, a, b, t in
             request_stream(FE_BATCH, 2, key_hi=capacity // 2)]
    kinds = {k: sum(r.kind == k for r in batch) for k in
             ("add_edge", "add_vertex", "remove_edge", "remove_vertex",
              "reachable")}
    engine = fe.primary.engine
    prof = _profiled_call(lambda: fe._commit_sync(batch), device)
    say("replication", f"(e) one profiled front-end tick ({kinds}), "
        f"subbatches={FE_BATCH}: " + _profile_line(prof))
    fe.primary.engine = engine.with_options(subbatches=1)
    prof = _profiled_call(lambda: fe._commit_sync(batch), device)
    say("replication", "(e) the same tick at subbatches=1 (joint aborts; "
        "for the cost only): " + _profile_line(prof))
    del fe
    for reader in ("snapshot", "replica"):
        for share in (0.25, 0.8):
            out = serve.serve_frontend(
                load=share * rate, duration=duration, capacity=capacity,
                batch=FE_BATCH, reader=reader, replicas=REP_REPLICAS,
                device=device)
            check(out["row_products"] == 0, "front-end reads did products")
            say("replication", f"(e) serve_frontend {reader} at "
                f"{share:.0%} of the saturated rate ({share * rate:.0f} "
                f"req/s offered, {duration:.1f}s): p50 "
                f"{out['p50_us'] / 1e3:.3f} ms, p99 {out['p99_us'] / 1e3:.3f} "
                f"ms, {out['ops_per_s']:.0f} req/s served, "
                f"{out['n_served']} served, {out['n_shed']} shed, "
                f"{out['ticks']} ticks, row_products={out['row_products']}")


def phase_replication():
    """Phase 8 (a)-(e).  Returns the replay's launches of B2-B5."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    replication_parity()
    total = replication_dense()
    for k, v in replication_tiled().items():
        total[k] += v
    replication_chaos()
    replication_frontend()
    say("replication", f"replay launches {total}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return total


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    # the SGT path's small float32 products hold 0/1 values (exact either
    # way) and the LM and xDeepFM parity runs compare float32 card and
    # CPU: full float32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    records = phase_kernels()
    phase_parity()
    launches = phase_main_path()
    launches["flash_attention"] = phase_lm()["flash_attention"]
    launches["embbag"] = phase_recsys()["embbag"]
    for k, v in phase_replication().items():
        launches[k] += v
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
