"""Tensor ops of the port: plain PyTorch, and the wrappers of the
hand-written CUDA kernels (K1 ``seg_scan``, K2 and K2w ``conv2d``, K3
``stamp``, K4 ``nms``, T1-T4 ``wgrad_variants``); the host pipeline's numpy
box geometry (``host_boxes``) and native library (``host_native``)."""
