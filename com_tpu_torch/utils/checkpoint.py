"""Checkpoints with ``torch.save`` (counterpart of
``com_tpu/utils/checkpoint.py``; reference train_utils.py:330-387,
detector3d_template.py:330-415, tools/train.py:150-162).

One file an epoch, ``checkpoint_epoch_{N}.pth``, in the reference's layout,
``{"model_state", "optimizer_state", "epoch", "it", "version"}``, so a
reference ``.pth`` loads through ``load_params_only`` as it is.  Beside
those: ``"step"``, ``"curriculum"`` (each head group's curriculum state,
its fields and a ``"kind"`` tag: ``CurriculumState`` or
``AnchorCurriculumState``),
``"conf"`` (the epoch's confidence accumulators) and ``"sampler"``
(``{"confidence_groups": (C, G) tensor}``): the curriculum EMA and the
sampler's confidences survive a resume, which the reference loses.  The
optimizer's state carries its step ``count`` (``AdamOneCycle.state_dict``).
A payload holds tensors, numbers and strings only, so it loads with
``torch.load(weights_only=True)``.  Saves go to a temporary file renamed
into place; the epoch files are pruned to the newest ``max_ckpt_save_num``;
``latest_model.pth`` is the rolling in-epoch save.
"""
from __future__ import annotations

import os
import pickle
import re
from pathlib import Path

import numpy as np
import torch

from ..parallel.mesh import rank_and_world, replicate_state
from ..parallel.sharding import active_mesh

VERSION = "com_tpu_torch-0.1"
LATEST = "latest_model.pth"

def _curriculum_kinds() -> dict:
    """kind tag -> the curriculum state's NamedTuple."""
    from ..losses.anchor_losses import AnchorCurriculumState
    from ..losses.curriculum import CurriculumState

    return {"CurriculumState": CurriculumState, "AnchorCurriculumState": AnchorCurriculumState}


def _curriculum_payload(c) -> dict:
    return {"kind": type(c).__name__, **c._asdict()}


def _curriculum_from_payload(c: dict, want: str, dev):
    """A payload entry as the NamedTuple of kind ``want`` (the state's own);
    an entry without a tag is a ``CurriculumState``."""
    kind = c.get("kind", "CurriculumState")
    if kind != want:
        raise ValueError(f"checkpoint holds a {kind}, the model a {want}")
    cls = _curriculum_kinds()[kind]
    return cls(*(c[f].to(dev) for f in cls._fields))


def _ckpt_files(ckpt_dir):
    """[(epoch, path)] of the epoch checkpoints, oldest first."""
    out = []
    for p in Path(ckpt_dir).glob("checkpoint_epoch_*.pth"):
        m = re.fullmatch(r"checkpoint_epoch_(\d+)\.pth", p.name)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def state_payload(state, epoch: int, it: int, sampler_state: dict | None = None) -> dict:
    """The checkpoint of a ``TrainState``: tensors stay where they are
    (``torch.save`` copies them to the host)."""
    payload = {
        "model_state": state.net.state_dict(),
        "optimizer_state": state.optimizer.state_dict(),
        "epoch": int(epoch), "it": int(it), "version": VERSION, "step": int(state.step),
        "curriculum": [_curriculum_payload(c) for c in state.curriculum],
        "conf": ({} if state.conf_sum is None
                 else {"conf_sum": state.conf_sum, "conf_cnt": state.conf_cnt}),
    }
    if sampler_state is not None:
        payload["sampler"] = {k: torch.from_numpy(np.array(v)) for k, v in sampler_state.items()}
    return payload


def _main_rank() -> bool:
    """Rank 0 of the active data mesh, or the single process, writes
    checkpoints; the other ranks hold the same state."""
    return rank_and_world()[0] == 0


def _save(payload: dict, path: Path) -> Path:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(state, ckpt_dir, epoch: int, it: int, sampler_state: dict | None = None,
                    max_ckpt_save_num: int = 50) -> Path:
    """Write ``checkpoint_epoch_{epoch}.pth`` and prune the oldest epoch
    files beyond ``max_ckpt_save_num`` (train_utils.py:334-339); on a rank
    other than 0, write nothing and return None."""
    if not _main_rank():
        return None
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = _save(state_payload(state, epoch, it, sampler_state),
                 ckpt_dir / f"checkpoint_epoch_{epoch}.pth")
    existing = _ckpt_files(ckpt_dir)
    while len(existing) > max_ckpt_save_num:
        existing.pop(0)[1].unlink(missing_ok=True)
    return path


def save_latest(state, ckpt_dir, epoch: int, it: int) -> Path:
    """The rolling in-epoch save, ``latest_model.pth`` (train_utils.py:198-206),
    overwritten in place and never pruned; rank 0's only, as
    ``save_checkpoint``."""
    if not _main_rank():
        return None
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    return _save(state_payload(state, epoch, it), ckpt_dir / LATEST)


def restore_state(state, payload: dict):
    """Load a payload into ``state`` in place: the model's parameters and
    buffers, the optimizer (moments and count), the curriculum states, the
    confidence accumulators and the step; under an active data mesh, then
    ``replicate_state``."""
    dev = state.device
    state.net.load_state_dict(payload["model_state"])
    state.optimizer.load_state_dict(payload["optimizer_state"])
    cur = payload["curriculum"]
    if len(cur) != len(state.curriculum):
        raise ValueError(f"checkpoint has {len(cur)} curriculum states, the model "
                         f"{len(state.curriculum)}")
    state.curriculum = tuple(_curriculum_from_payload(c, type(own).__name__, dev)
                             for c, own in zip(cur, state.curriculum))
    conf = payload["conf"]
    if state.conf_sum is not None and conf:
        state.conf_sum.copy_(conf["conf_sum"])
        state.conf_cnt.copy_(conf["conf_cnt"])
    state.step = int(payload["step"])
    mesh = active_mesh()
    # every rank reads the same file; rank 0's copy is broadcast as a guard
    return state if mesh is None else replicate_state(state, mesh)


def load_checkpoint(path, state=None, map_location=None) -> dict:
    """The payload of a checkpoint file (``weights_only=True``), its tensors
    on ``map_location`` (the state's device when a ``state`` is given);
    with ``state``, also restored into it."""
    if state is not None and map_location is None:
        map_location = state.device
    payload = torch.load(Path(path), map_location=map_location, weights_only=True)
    if state is not None:
        restore_state(state, payload)
    return payload


def sampler_confidences(payload: dict):
    """The sampler's (C, G) confidences of a payload as numpy, or None."""
    if "sampler" not in payload:
        return None
    return payload["sampler"]["confidence_groups"].cpu().numpy()


def load_params_only(path, net: torch.nn.Module, logger=None):
    """Initialise ``net``'s parameters and buffers from a checkpoint,
    keeping its own value where a key is absent or its shape differs
    (detector3d_template.load_params_from_file:330-384).  Takes this
    package's files and the reference's ``.pth`` (``model_state``).  A
    reference file can hold pickled objects beside its tensors, which
    ``weights_only=True`` refuses; such a file is read again with
    ``weights_only=False`` and the logger says so: load only files you
    trust.  A sparse conv weight loads from either spconv layout: 2.x's
    (Cout, kz, ky, kx, Cin), the port's own, or 1.x's (kz, ky, kx, Cin,
    Cout), transposed on the way in (as the JAX package's ``t_spconv``
    accepts both).

    A pcdet voxel checkpoint's first BEV conv (``backbone_2d.blocks.0.1``)
    loads unpermuted, as the JAX package's importer leaves it: pcdet's
    HeightCompression orders its channels ``c*D + d``, both packages
    ``d*C + c`` (ROADMAP Queue 3), so such a file's BEV input channels
    arrive mixed in both.  Returns (loaded, skipped) counts."""
    try:
        payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        if logger:
            logger.warning("%s holds more than tensors: read with weights_only=False", path)
        payload = torch.load(Path(path), map_location="cpu", weights_only=False)
    src = payload.get("model_state", payload)
    own = net.state_dict()
    loaded = skipped = 0
    with torch.no_grad():
        for k, v in own.items():
            s = src.get(k)
            if s is None:
                continue
            s = torch.as_tensor(s)
            if s.dim() == 5 and tuple(s.shape) != tuple(v.shape):
                s = s.permute(4, 0, 1, 2, 3)  # spconv 1.x -> 2.x
            if tuple(s.shape) != tuple(v.shape):
                skipped += 1
                continue
            v.copy_(s.to(v.dtype))
            loaded += 1
    if logger:
        logger.info("pretrained: loaded %d tensors, skipped %d shape mismatches",
                    loaded, skipped)
    return loaded, skipped


def resume_latest(ckpt_dir, state=None, logger=None, map_location=None):
    """The newest readable checkpoint's payload, or None: newest epoch
    first, an unreadable file skipped for the next older one
    (tools/train.py:150-162); ``latest_model.pth`` outranks the epoch files
    when its epoch is at least the newest of theirs.  With ``state``, the
    payload is also restored into it (a checkpoint that reads but does not
    fit the model raises)."""
    files = _ckpt_files(ckpt_dir)
    newest = files[-1][0] if files else None
    order = [p for _, p in reversed(files)]
    latest = Path(ckpt_dir) / LATEST
    if latest.exists():
        order.insert(0, latest)
    if state is not None and map_location is None:
        map_location = state.device
    for path in order:
        try:
            payload = torch.load(path, map_location=map_location, weights_only=True)
        except Exception as e:  # a corrupt or cut file: try the next older one
            if logger:
                logger.warning("checkpoint %s unreadable (%s); trying older", path, e)
            continue
        if path == latest and newest is not None and int(payload["epoch"]) < newest:
            continue
        if state is not None:
            restore_state(state, payload)
        if logger:
            logger.info("resumed from %s (epoch %d, it %d)", path, payload["epoch"],
                        payload["it"])
        return payload
    return None
