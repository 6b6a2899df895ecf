"""The model zoo's port: the dense decoder-only LM (`transformer`) with
its building blocks (`common`) and attention (`attention`); xDeepFM and
its embedding table (`recsys`); the MLP helpers (`gnn.graphs`)."""
