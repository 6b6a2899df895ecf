"""Core library of the port: the slab (`dag`), Algorithms 1 and 2
(`reachability`, `snapshot`), the closure cache (`closure_cache`), the
cost model (`dispatch`), the batched cycle check (`acyclic`), the session
façade (`engine`, `snapshot_view`) and the SGT scheduler (`sgt`)."""
