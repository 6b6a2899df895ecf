"""Kernels of two source trees, timed turn for turn on one card.

    python src/repro_torch/launch/tiled_call_turns.py \\
        --tree before=path/to/other/src --tree after=src

runs one process per tree in the order before, after, after, before, each
with that tree's ``src`` first on ``PYTHONPATH``, so each process builds
and calls its own tree's wrappers (``repro_torch.kernels.ops``).  A process
makes each case's operands from a seed, checks the kernel against its
plain version (bit for bit; B6 within its rounding bound, K 2^-23
sum_k |w_k t_k|), and times it as ``chip_smoke.py`` phase 3 does: TURNS
rounds of kernel, library, library, kernel (CUDA events, a mean over a
case's reps a turn; the library yardstick is one fp16 ``torch.matmul`` of
the unpacked operands, for B6 one ``F.embedding_bag``), the kernel's
device time per call alone (``torch.profiler``: its launches, B1-B3's
first one included) and the host's wall time a call of calls issued
without a sync.  The cases: B4 and B5 at the tiled main path's shapes
(R=1024, B=128, 1% dense; B5 with 1% and 25% of rows affected); B1, B2
and B3 at the dense main path's (C=16384: B1's squaring and its frontier
hop of 1024 rows, 1% dense; B2's fold of B=1024 rows with a 1% and a 50%
dense mask, and the last fold of the insheavy and of the delheavy stream,
captured through the engine's hook; B3 with 1% and 25% of rows affected)
and on the closure of a
seeded 1%-dense upper-triangular DAG at C=16384 (B1 squaring it, B3 with
every row affected), built by each tree's own closure loop; B6 at the
xDeepFM linear term's shape (R=33,001,472, D=1, B=512, K=39) and at
kernel_bench's (R=10^6, D=64, B=4096, K=4), float32, unit weights.  Each
process prints one JSON line; the parent prints them all and, last, each
tree's two values of each time, sorted.  The file imports only what both
trees have, so it runs against a tree that lacks it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

R, B, DENSITY, TURNS, REPS = 1024, 128, 0.01, 5, 1000
C, HOP = 16384, 1024   # the dense main path's capacity and batch


def _cuda_ms(fn, reps: int) -> float:
    import torch
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


def _host_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _device_ms(fn, reps: int, kernel: str) -> float:
    """Device ms a call of ``fn``: the mean of each of the kernel's
    launches (``kernel``_kernel, B6's ``kernel``_kernel_ksplit, and
    B1-B3's first launch ``kernel``_work_kernel where the tree has one),
    summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = 0.0
    for tag in ("_kernel", "_work_kernel"):
        events = [e for e in prof.key_averages()
                  if f"{kernel}{tag}" in e.key]
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in events)
        ms += us / 1e3 / max(1, sum(e.count for e in events))
    return ms


def captured_fold(profile: str, ticks: int = 6):
    """(closure, mask, rows) of the last B2 call of a dense main-path
    stream at C=16384, batch 1024 ("insheavy": 512 conflict edges a tick,
    so the fold's B is 512; "delheavy"), method "auto", seed 0, captured
    through the engine's ``closure_update_impl`` hook."""
    from repro_torch.core.engine import DagEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    folds = []

    def record(closure, mask, rows):
        folds[:] = [(closure.clone(), mask.clone(), rows.clone())]
        return ops.closure_update(closure, mask, rows)

    eng = DagEngine.create(C, method="auto", device="cuda",
                           closure_update_impl=record)
    if profile == "insheavy":
        tick = serve.insert_heavy_tick
        inputs = serve._sgt_insert_heavy_inputs(C, HOP, ticks, 0)
    else:
        tick = serve.churn_tick
        inputs = serve._sgt_churn_inputs(C, HOP, ticks, 0, profile)
    for xs in inputs:
        eng, _ = tick(eng, serve.on_device("cuda", xs))
    if not folds:
        raise SystemExit(f"the {profile} stream made no B2 call")
    return folds[0]


def one_tree(label: str) -> dict:
    """Times of this process's tree (whichever ``repro_torch`` imports)."""
    import numpy as np
    import torch
    from repro_torch.core import bitset, reachability
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)

    def packed(shape, density):
        return bitset.pack_bits(torch.rand(shape, generator=gen,
                                           device="cuda") < density)

    def bit_case(op, args, lib_args, reps, lib_reps, single=False):
        """A bit kernel: (kernel, check, library, reps, library reps)."""
        def kernel():
            out = op(*args, impl="cuda")
            return (out,) if single else out

        def check():
            want = op(*args, impl="ref")
            return all(torch.equal(g, w) for g, w in zip(
                kernel(), (want,) if single else want))

        a, b = (bitset.unpack_bits(x).to(torch.float16) for x in lib_args)
        return kernel, check, lambda: torch.matmul(a, b), reps, lib_reps

    def bag_case(rows, d, b, k):
        """B6 on a float32 table (rows, d) ~ N(0, 1), uniform idx (b, k),
        unit weights."""
        table = torch.randn((rows, d), generator=gen, device="cuda")
        idx = torch.randint(0, rows, (b, k), generator=gen, device="cuda",
                            dtype=torch.int32)
        w = torch.ones((b, k), device="cuda")

        def kernel():
            return ops.embedding_bag(table, idx, w, impl="cuda")

        def check():
            err = (kernel() - ops.embedding_bag(table, idx, w, impl="ref"))
            mag = (table[idx.long()].abs() * w[..., None]).sum(1)
            return bool((err.abs() <= k * 2.0 ** -23 * mag).all())

        def library():
            return torch.nn.functional.embedding_bag(
                idx, table, per_sample_weights=w, mode="sum")

        return kernel, check, library, 1000, 1000

    # name -> (kernel, check, library, kernel reps, library reps)
    tiles, s = packed((R, R), DENSITY), packed((R, R), DENSITY)
    mask, rows = packed((R, B), DENSITY), packed((B, R), DENSITY)
    cases = {"closure_update_tiled": bit_case(
        ops.closure_update_tiled, (tiles, mask, rows), (mask, rows), REPS,
        REPS)}
    for frac in (0.01, 0.25):
        cases[f"closure_delete_tiled {frac:.0%} affected"] = bit_case(
            ops.closure_delete_tiled, (tiles, s, packed((R,), frac)),
            (tiles, s), REPS, REPS)
    lhs, rhs = packed((C, C), DENSITY), packed((C, C), DENSITY)
    front = packed((HOP, C), DENSITY)
    cases["bitmm squaring 1%"] = bit_case(ops.bitmm_packed, (lhs, rhs),
                                          (lhs, rhs), 10, 3, single=True)
    cases["bitmm frontier hop 1%"] = bit_case(
        ops.bitmm_packed, (front, rhs), (front, rhs), 50, 20, single=True)
    fold_rows = packed((HOP, C), DENSITY)
    for md in (0.01, 0.5):
        fold_mask = packed((C, HOP), md)
        cases[f"closure_update {md:.0%} mask"] = bit_case(
            ops.closure_update, (lhs, fold_mask, fold_rows),
            (fold_mask, fold_rows), 20 if md < 0.1 else 5, 5, single=True)
    for profile in ("insheavy", "delheavy"):
        fold = captured_fold(profile)
        cases[f"closure_update {profile} fold"] = bit_case(
            ops.closure_update, fold, fold[1:], 50, 20, single=True)
    for frac in (0.01, 0.25):
        cases[f"closure_delete {frac:.0%} affected"] = bit_case(
            ops.closure_delete, (lhs, rhs, packed((C,), frac)), (lhs, rhs),
            10, 3, single=True)
    adj = torch.rand((C, C), generator=gen, device="cuda") < DENSITY
    closure = reachability.transitive_closure(
        bitset.pack_bits(torch.triu(adj, diagonal=1)))
    del adj
    every = torch.full((C // 32,), -1, dtype=torch.int32, device="cuda")
    cases["bitmm squaring the closure"] = bit_case(
        ops.bitmm_packed, (closure, closure), (closure, closure), 3, 3,
        single=True)
    cases["closure_delete closure, every row affected"] = bit_case(
        ops.closure_delete, (closure, closure, every), (closure, closure), 3,
        3, single=True)
    cases["embbag xDeepFM D=1 K=39 B=512"] = bag_case(33_001_472, 1, 512, 39)
    cases["embbag kernel_bench D=64 K=4 B=4096"] = bag_case(1_000_000, 64,
                                                            4096, 4)
    out = {"tree": label, "src": os.environ.get("PYTHONPATH", "")}
    for name, (kernel, check, library, reps, lib_reps) in cases.items():
        if not check():
            raise SystemExit(f"{label}: {name} disagrees with its plain "
                             "version")
        k_turns, l_turns = [], []
        for _ in range(TURNS):
            k_turns.append(_cuda_ms(kernel, reps))
            l_turns += [_cuda_ms(library, lib_reps),
                        _cuda_ms(library, lib_reps)]
            k_turns.append(_cuda_ms(kernel, reps))
        out[name] = {
            "kernel_ms": float(np.median(k_turns)),
            "library_ms": float(np.median(l_turns)),
            "won": sum(k < lt for k, lt in zip(k_turns, l_turns)),
            "of": len(k_turns),
            "device_ms": _device_ms(kernel, min(reps, 200),
                                    name.split()[0]),
            "host_ms": _host_ms(kernel, reps),
            "library_host_ms": _host_ms(library, lib_reps)}
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=SRC", help="a tree's label and its src "
                    "directory; two trees run in the order A, B, B, A")
    ap.add_argument("--one", metavar="LABEL",
                    help="time this process's tree only (used by the "
                    "parent process)")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_tree(args.one)), flush=True)
        return 0
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) != 2:
        ap.error("give two --tree LABEL=SRC")
    results = []
    for label, src in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        line = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", label],
            env=env, check=True, stdout=subprocess.PIPE,
            text=True).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    summary = {}
    for label, _ in trees:
        mine = [r for r in results if r["tree"] == label]
        summary[label] = {
            name: {k: sorted(r[name][k] for r in mine)
                   for k in ("kernel_ms", "library_ms", "device_ms",
                             "host_ms")}
            for name in mine[0] if name not in ("tree", "src")}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
