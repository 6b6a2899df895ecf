"""PyTorch / CUDA port of the concurrent-DAG reproduction (`repro`).

`repro_torch` mirrors `repro`'s module names (`core/dag.py`,
`core/engine.py`, `kernels/ops.py`, `launch/serve.py`, ...) and is held
against it by the `tests/test_torch_*.py` tests.  It imports torch and
numpy, never JAX and nothing of `repro`.

The hand-written Hopper kernels live in `csrc/` (CUDA C++ for sm_90a),
are built at first use by `kernels/_build.py` and dispatched by
`kernels/ops.py`.  Engines run on the card unless created with
``device="cpu"``.
"""
