"""The port of `repro.models.gnn`: so far only the MLP helpers of
`graphs` that xDeepFM uses (the GNN models wait for ROADMAP.md section A
item 12c)."""
