"""com_tpu_torch — the PyTorch/CUDA port of com_tpu for NVIDIA Hopper.

A second package beside ``com_tpu`` (the JAX reference, which it never
imports).  Its modules mirror ``com_tpu``'s layout; plain tensor code is
PyTorch, and each Pallas kernel of the JAX package on the ported paths is a
CUDA C++ kernel under ``csrc/`` built for ``sm_90a`` at first use.
CenterPoint-Pillar is served (``models.detectors.build_network``,
``train.eval.make_eval_step``, ``serving.server.BatchServer``) and trained
with COMLoss and the epoch-end COMAug feedback (``train.optim``,
``train.state``, ``train.step.make_train_step``, ``train.loop.train_model``),
fed by the host data pipeline (``data``: ``build_dataloader``, the COMAug
samplers, augmentation, processing, collate; native host ops in
``ops.host_native``) whose sampler reads that feedback, checkpointed
(``utils.checkpoint``) and evaluated (``train.eval.eval_model``, the
datasets' ``evaluation``) through the train, test and demo CLIs
(``tools.train``, ``tools.test``, ``tools.demo``), on kernels K1 (``ops.seg_scan``, forward and backward), K2 and K2w
(``ops.conv2d``, forward, dgrad and wgrad), K3 (``ops.stamp``) and K4
(``ops.nms``).  ``tools.perf.microbench_wgrad_kernels`` sweeps four
tensor-core formulations of the conv weight gradient, T1-T4
(``ops.wgrad_variants``), against K2w.
"""
