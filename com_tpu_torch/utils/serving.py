"""Serving export: freeze a model's eval step into a self-contained artifact
(counterpart of ``com_tpu/utils/serving.py``).

``torch.export`` traces the eval step (``train/eval.py`` ``make_eval_step``,
CenterPoint or anchor branch) with the weights that live in the model, so
they are saved with the program.  Loading the artifact needs torch and the
port's registered ops (K1 ``run_bcast``, K2 ``conv3x3``, K4
``greedy_suppress``: ``ops/seg_scan.py``, ``ops/conv2d.py``,
``ops/nms.py``), never the model code.  On a CUDA tensor an op launches
its kernel, built from ``csrc/`` at first use if it is not built yet; on a
CPU tensor it runs its plain version.  A program exported on one device
runs on another after ``torch.export.passes.move_to_device_pass``, the
counterpart of the JAX artifact's ``platforms=("cpu", "tpu")``.

Artifact layout: ``<stem>.pt2`` (``torch.export.save``) and ``<stem>.json``
(the manifest: class names, ranges, input spec, the export's device).
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from ..ops import conv2d, nms, seg_scan  # noqa: F401  (registers the ops a program calls)
from .device import resolve_device

INPUT_KEYS = ("points", "points_mask")


class _EvalStep(torch.nn.Module):
    """The eval step as a module of the detector, for ``torch.export``."""

    def __init__(self, net, step):
        super().__init__()
        self.net = net
        self._step = step

    def forward(self, points, points_mask):
        return self._step({"points": points, "points_mask": points_mask})


def export_eval_step(net, model_cfg, class_names, meta, batch_spec: dict, device=None):
    """The ``torch.export.ExportedProgram`` of ``make_eval_step(net, ...)``
    on ``device`` (CUDA unless the caller passes another; ``net`` must be
    there), weights included.

    batch_spec: {"points": ((B, N, F), dtype), "points_mask": ((B, N),
    dtype)}, dtypes as torch dtypes or their names (a manifest's
    ``input_spec`` is accepted directly).  The program takes points and
    points_mask only, as the JAX export does: a model whose inputs are
    voxels raises."""
    from ..train.eval import make_eval_step
    from ..train.step import model_input_keys

    keys = model_input_keys(model_cfg)
    if keys != set(INPUT_KEYS):
        raise NotImplementedError(
            f"{model_cfg['NAME']} ({model_cfg['VFE']['NAME']}) reads {sorted(keys)}: the "
            f"export takes {list(INPUT_KEYS)} only")
    dev = resolve_device(device)
    step = make_eval_step(net, model_cfg, list(class_names), meta, device=dev)
    example = tuple(torch.zeros(tuple(shape), dtype=_dtype(dtype), device=dev)
                    for shape, dtype in (batch_spec[k] for k in INPUT_KEYS))
    return torch.export.export(_EvalStep(net, step), example, strict=False)


def write_artifact(stem, program, manifest: dict) -> None:
    """``<stem>.pt2`` and ``<stem>.json``."""
    stem = Path(stem)
    stem.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, stem.with_suffix(".pt2"))
    stem.with_suffix(".json").write_text(json.dumps(manifest, indent=2))


def _program_device(program) -> torch.device:
    return next(iter(program.state_dict.values())).device


def drop_metadata_asserts(module):
    """Take every ``aten._assert_tensor_metadata`` node out of a loaded
    program's graphs, in place, and return the module.  ``torch.export``
    guards each dtype cast of the traced step with one (152 a flagship
    forward); they check metadata that the fixed graph and its checked
    inputs already determine, and cost the host ~84 us each on the card
    (12.8 ms of a batch's issue time, ``tools/perf/artifact_trace.py``)."""
    target = torch.ops.aten._assert_tensor_metadata.default
    for sub in module.modules():
        graph = getattr(sub, "graph", None)
        if isinstance(graph, torch.fx.Graph):
            for node in [n for n in graph.nodes if n.target is target]:
                graph.erase_node(node)
            sub.recompile()
    return module


def load_artifact(stem, device=None):
    """Returns (run, manifest): ``run(batch) -> (boxes, scores, labels,
    valid)`` on ``device`` (CUDA unless the caller passes another).  batch
    holds "points" and "points_mask" as numpy arrays or tensors.  A program
    exported on another device is moved first (``move_to_device_pass``);
    its metadata asserts are dropped (``drop_metadata_asserts``)."""
    from torch.export.passes import move_to_device_pass

    stem = Path(stem)
    dev = resolve_device(device)
    manifest = json.loads(stem.with_suffix(".json").read_text())
    program = torch.export.load(stem.with_suffix(".pt2"))
    if _program_device(program) != dev:
        program = move_to_device_pass(program, dev)
    module = drop_metadata_asserts(program.module())

    @torch.no_grad()
    def run(batch):
        return tuple(module(*(torch.as_tensor(batch[k], device=dev) for k in INPUT_KEYS)))

    return run, manifest


def _dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def batch_spec_from_manifest(manifest: dict) -> dict:
    """{name: (shape, torch dtype)} from the manifest's ``input_spec``."""
    return {k: (tuple(shape), _dtype(dtype)) for k, (shape, dtype) in
            manifest["input_spec"].items()}


def make_manifest(cfg, meta, batch_spec: dict, platforms) -> dict:
    """The JAX manifest's keys; ``platforms`` is the export's device type,
    ``["cpu"]`` or ``["cuda"]``."""
    return {
        "model": cfg.MODEL["NAME"],
        "class_names": list(meta.class_names),
        "point_cloud_range": [float(v) for v in meta.point_cloud_range],
        "voxel_size": [float(v) for v in meta.voxel_size],
        "grid_size": [int(v) for v in meta.grid_size],
        "platforms": list(platforms),
        "input_spec": {
            k: [[int(d) for d in shape], str(_dtype(dtype)).removeprefix("torch.")]
            for k, (shape, dtype) in batch_spec.items()
        },
        "output": ["boxes (B,K,7+)", "scores (B,K)", "labels (B,K)", "valid (B,K) bool"],
    }
