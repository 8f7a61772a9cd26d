"""Hand-written CUDA kernels (sources in `csrc/`), their wrappers and their
plain PyTorch twins.  Nothing is built at import time."""
