"""Tensor ops of the port: plain PyTorch, and the wrappers of the
hand-written CUDA kernels (K1 ``seg_scan``, K2 ``conv2d``, K4 ``nms``)."""
