"""Hand-written CUDA kernels B1-B5 (`csrc/`), their plain torch versions
(`ref`) and the dispatcher (`ops`)."""
