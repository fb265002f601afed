"""Checkpoint and resume (port of ``deeplabv3plus_keras_tpu/train/checkpoint.py:23-190``).

The reference keeps the best-val-loss model (Keras ``ModelCheckpoint(
monitor='val_loss', save_best_only=True)``) in the directory
``semantic_segmentation_deeplabv3plus`` and reloads it under
``model_loading`` (semantic_segmentation.py:454, 482-490, 983-986).  The
JAX package keeps its state with Orbax; the port keeps ``state_dict``s:
the model's (weights and BN statistics) and the optimizer's
(:meth:`KerasAdam.state_dict`: moments, update count, learning rate), in
``<slot>/state.pt``.

Two slots, so a preemption save never replaces the best-val weights:

- ``state``: the best-val-loss checkpoint;
- ``state.resume``: unconditional saves (SIGTERM); a later best save
  deletes it.

Each slot is written whole to ``<slot>.tmp`` with its ``slot_meta.json``
(step, and val_loss for the best slot) inside, then renamed into place,
the previous slot kept at ``<slot>.old`` until the rename lands: a crash at
any point leaves a restorable slot.  :func:`restore_checkpoint` takes the
slot with the larger step.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

MODEL_DIR = "semantic_segmentation_deeplabv3plus"  # the reference's (:454)
SLOT_META = "slot_meta.json"
STATE_FILE = "state.pt"


def _ckpt_dir(base_dir: str | None) -> str:
    return os.path.abspath(os.path.join(base_dir or ".", MODEL_DIR))


def _read_meta(path: str) -> dict:
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def _write_meta(path: str, meta: dict) -> None:
    """meta.json is informational (slots are chosen by their own
    sidecars); written atomically all the same."""
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + ".tmp", meta_path)


def _slot_meta(slot_dir: str | None) -> dict:
    """The sidecar written inside a slot before its rename publishes it, so
    a slot's weights and its step and val_loss never disagree."""
    if slot_dir is None:
        return {}
    p = os.path.join(slot_dir, SLOT_META)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def _training_state(model: torch.nn.Module, optimizer) -> dict:
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict()}


def _atomic_save(state: dict, tree_path: str, slot_meta: dict) -> None:
    tmp_path, old_path = tree_path + ".tmp", tree_path + ".old"
    for stale in (tmp_path, old_path):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp_path)
    torch.save(state, os.path.join(tmp_path, STATE_FILE))
    with open(os.path.join(tmp_path, SLOT_META), "w") as f:
        json.dump(slot_meta, f)
    if os.path.exists(tree_path):
        os.rename(tree_path, old_path)
    os.rename(tmp_path, tree_path)
    if os.path.exists(old_path):
        shutil.rmtree(old_path)


def _slot_path(path: str, slot: str) -> str | None:
    """A slot's directory, or its '.old' where a crash fell between the
    two renames."""
    for p in (os.path.join(path, slot), os.path.join(path, slot + ".old")):
        if os.path.exists(p):
            return p
    return None


def _drop_resume(path: str) -> None:
    for stale in ("state.resume", "state.resume.old", "state.resume.tmp"):
        sp = os.path.join(path, stale)
        if os.path.exists(sp):
            shutil.rmtree(sp)


def save_checkpoint(model: torch.nn.Module, optimizer, base_dir: str | None = None, *,
                    val_loss: float | None = None, best_only: bool = True) -> bool:
    """Best-val retention (``best_only=True``: written only when
    ``val_loss`` beats the best slot's) or an unconditional save into the
    resume slot (``best_only=False``, a SIGTERM).  Returns True if
    written."""
    path = _ckpt_dir(base_dir)
    os.makedirs(path, exist_ok=True)
    meta = _read_meta(path)
    step = int(optimizer.iterations)
    if not best_only:
        _atomic_save(_training_state(model, optimizer), os.path.join(path, "state.resume"),
                     {"step": step})
        meta["resume_step"] = step
        _write_meta(path, meta)
        return True
    best = _slot_meta(_slot_path(path, "state")).get("val_loss", meta.get("best_val_loss"))
    if val_loss is not None and best is not None and val_loss >= best:
        return False
    new_best = float(val_loss) if val_loss is not None else best
    _atomic_save(_training_state(model, optimizer), os.path.join(path, "state"),
                 {"step": step, "val_loss": new_best})
    _drop_resume(path)  # this best save supersedes an earlier resume save
    _write_meta(path, {"best_val_loss": new_best, "step": step})
    return True


def restore_checkpoint(model: torch.nn.Module, optimizer, base_dir: str | None = None) -> int:
    """Load the latest slot (a resume save beats an older best save) into
    ``model`` and ``optimizer`` in place, on their devices; returns the
    restored step."""
    path = _ckpt_dir(base_dir)
    meta = _read_meta(path)
    best_path = _slot_path(path, "state")
    resume_path = _slot_path(path, "state.resume")
    best_step = _slot_meta(best_path).get("step", meta.get("step", 0))
    resume_step = _slot_meta(resume_path).get("step", meta.get("resume_step", -1))
    tree_path = best_path
    if resume_path is not None and (best_path is None or resume_step >= best_step):
        tree_path = resume_path
    if tree_path is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    device = next(model.parameters()).device
    state = torch.load(os.path.join(tree_path, STATE_FILE), map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(optimizer.iterations)


def clear_resume_checkpoint(base_dir: str | None = None) -> None:
    """Drop the resume slot (training ended normally: the best-val slot is
    the run's artifact)."""
    path = _ckpt_dir(base_dir)
    _drop_resume(path)
    meta = _read_meta(path)
    if meta.pop("resume_step", None) is not None and os.path.isdir(path):
        _write_meta(path, meta)


def checkpoint_exists(base_dir: str | None = None) -> bool:
    path = _ckpt_dir(base_dir)
    return _slot_path(path, "state") is not None or _slot_path(path, "state.resume") is not None
