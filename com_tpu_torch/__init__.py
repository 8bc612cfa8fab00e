"""com_tpu_torch — the PyTorch/CUDA port of com_tpu for NVIDIA Hopper.

A second package beside ``com_tpu`` (the JAX reference, which it never
imports).  Its modules mirror ``com_tpu``'s layout; plain tensor code is
PyTorch, and each Pallas kernel of the JAX package on the ported path is a
CUDA C++ kernel under ``csrc/`` built for ``sm_90a`` at first use.  This
slice serves CenterPoint-Pillar: ``models.detectors.build_network``,
``train.eval.make_eval_step`` and ``serving.server.BatchServer``, on kernels
K1 (``ops.seg_scan``), K2 (``ops.conv2d``) and K4 (``ops.nms``).
"""
