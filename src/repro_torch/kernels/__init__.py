"""The port's kernels: hand-written CUDA for Hopper, each with its plain
PyTorch version; `ops` routes by the tensor's device."""
