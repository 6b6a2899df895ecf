"""Hand-written CUDA kernels B1-B5 and B7 (`csrc/`), their plain torch
versions (`ref`) and the dispatcher (`ops`)."""
