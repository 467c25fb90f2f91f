"""Checkpoints: the full train state with ``torch.save`` for resume, the
compact params bundle in the JAX package's format for serving, and the
import of a reference ``.pth`` (JAX counterpart: train/checkpoint.py, whose
full state goes through Orbax; Orbax is not used here and its checkpoints
are not read).

The full state of a :class:`~.steps.TrainStep`: the model's ``state_dict``
(parameters and BatchNorm running statistics), AdamW's ``mu``, ``nu`` and
``count``, and the state of the generator of the dropout (and of the
``rand`` source's semantics).  A restore copies into the
step's own tensors, so their storage stays and their versions move (the
decoder's cached weight tables are rebuilt on the next decode)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import convert
from .steps import TrainStep

STATE_FILE = "train_state.pt"


def _state_path(path: str) -> str:
    return os.path.join(path, STATE_FILE)


def save_checkpoint(path: str, step: TrainStep) -> str:
    """Write ``step``'s full state into the directory ``path`` (made if
    missing; an earlier checkpoint there is replaced whole, through a
    temporary file).  Returns the file written."""
    os.makedirs(path, exist_ok=True)
    opt = step.optimizer
    state = {"model": step.model.state_dict(), "mu": opt.mu, "nu": opt.nu,
             "count": opt.count, "generator": step.generator.get_state()}
    out = _state_path(path)
    tmp = out + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, out)
    return out


@torch.no_grad()
def restore_checkpoint(path: str, step: TrainStep) -> TrainStep:
    """Load the state :func:`save_checkpoint` wrote in ``path`` into
    ``step`` (a trainer of the same configuration), in place; returns it."""
    state = torch.load(_state_path(path), map_location="cpu", weights_only=True)
    step.model.load_state_dict(state["model"], strict=True)
    opt = step.optimizer
    if len(state["mu"]) != len(opt.mu):
        raise ValueError(f"checkpoint {path}: {len(state['mu'])} moments for "
                         f"{len(opt.mu)} parameters")
    for dst, src in zip(opt.mu + opt.nu, state["mu"] + state["nu"]):
        dst.copy_(src)
    opt.count = int(state["count"])
    step.generator.set_state(state["generator"])
    return step


def save_params_bundle(path: str, model: torch.nn.Module, step_count: int = 0,
                       dtype: Optional[str] = "float16") -> None:
    """Write the model's parameters and running statistics, and
    ``__step__``, as the JAX package's compact npz bundle: a float array in
    ``dtype`` where all its values lie within 0.9 of that type's largest,
    else float32.  JAX ``restore_params_bundle`` and ``api.get_model`` read
    it."""
    flat = {"__step__": np.asarray(int(step_count), np.int64)}
    for key, arr in convert.state_dict_to_bundle(model.state_dict()).items():
        if dtype and arr.dtype.kind == "f":
            lim = np.finfo(np.dtype(dtype)).max * 0.9
            arr = arr.astype(dtype) if np.all(np.abs(arr) < lim) else arr.astype(np.float32)
        flat[key] = arr
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


@torch.no_grad()
def restore_params_bundle(path: str, model: torch.nn.Module) -> int:
    """Load a bundle (this module's or the JAX package's) into ``model``
    strictly, cast to its tensors' types; returns its ``__step__``."""
    flat = convert.load_bundle(path)
    model.load_state_dict(convert.bundle_to_state_dict(flat), strict=True)
    return int(flat.get("__step__", 0))


def import_torch_checkpoint(pth_path: str, model: torch.nn.Module,
                            skip_semantic_embed: bool = True,
                            strict: bool = False) -> Dict[str, Any]:
    """Load a reference ``.pth`` state dict into ``model``, in place on its
    own device, as the reference loader does: the semantic embed table is
    skipped and keys the model lacks, or lacks a counterpart for, are
    tolerated (``train.torch_import.convert_state_dict``, whose stats this
    returns).  A shape mismatch raises ValueError, and with ``strict`` a
    missing key KeyError, before the model is touched."""
    from .torch_import import convert_state_dict

    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    state_dict, stats = convert_state_dict(sd, model, skip_semantic_embed=skip_semantic_embed,
                                           strict=strict)
    model.load_state_dict(state_dict, strict=True)
    return stats
