"""LGRASS on PyTorch and CUDA: the port of the JAX package `repro`.

`repro_torch.core.lgrass_sparsify` is the entry point. The kernels of
its path are hand-written for Hopper (`csrc/`) and launched through
`repro_torch.kernels.ops`. This package never imports JAX or `repro`.
"""
