"""Checkpoints of the training state; port of ``rpst.train.checkpoint``.

One ``torch.save`` per checkpoint, ``<root>/<step>/state.pt``, holding
``{step, params, opt_state, rng}``: the model's state_dict (parameters
and buffers: sel_multi_adain's BatchNorm running statistics), the Adam
state_dict (moments and count), and the ``torch.Generator`` state. The
step is stored in the file and mirrored in the directory name. Restoring
all of it makes a resumed run continue the same computation.

A run on a ``model`` mesh axis (``dist.tp``) writes the one-device layout:
every rank joins the gather of the shares to the full shapes (parameters,
buffers and Adam moments; rpst's ``gather_replicated``) and one rank
writes, so a one-device run, serving or a resume on another mesh reads the
file as it reads any other; restoring onto a model axis keeps each rank's
slice again.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

from ..dist import tp

STATE_FILE = "state.pt"


def save_checkpoint(root, state, write: bool = True) -> str:
    """Write ``<root>/<state.step>/state.pt``; returns the directory. On a
    model axis every rank calls it (the shares are gathered) and those
    with ``write`` False write nothing."""
    path = Path(root).resolve() / str(state.step)
    # the one-device layout (a model without shares: its state_dicts)
    params = tp.full_state_dict(state.model)
    opt = tp.full_optimizer_state(state.optimizer)
    if not write:
        return str(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{STATE_FILE}.tmp"
    torch.save({"step": state.step, "params": params, "opt_state": opt,
                "rng": state.generator.get_state()}, tmp)
    os.replace(tmp, path / STATE_FILE)  # a reader never sees half a file
    return str(path)


def latest_step(root) -> Optional[int]:
    """The highest ``<root>/<step>`` that holds a checkpoint, or None."""
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(p.name) for p in root.iterdir()
             if p.is_dir() and re.fullmatch(r"\d+", p.name)
             and (p / STATE_FILE).exists()]
    return max(steps) if steps else None


def restore_checkpoint(path, state):
    """Load the checkpoint directory ``path`` into ``state`` (in place, and
    returned): parameters, Adam state, generator and step. A checkpoint
    whose optimizer covers other parameters than ``state``'s (one saved
    without wct's resume freeze, loaded into a frozen run) raises
    ``ValueError``, as rpst's restore does."""
    saved = torch.load(Path(path) / STATE_FILE, map_location="cpu",
                       weights_only=True)
    have, want = (sum(len(g["params"]) for g in groups) for groups in
                  (saved["opt_state"]["param_groups"],
                   state.optimizer.param_groups))
    if have != want:
        # rpst's orbax restore refuses the same checkpoint: a frozen
        # optimizer state (optax.multi_transform) has another tree
        raise ValueError(f"{path}: its optimizer state covers {have} "
                         f"parameters, this run trains {want}"
                         + (f" (frozen: {', '.join(state.frozen)}; a "
                            "checkpoint saved without the freeze cannot "
                            "resume a frozen run)" if state.frozen else ""))
    # each rank keeps its slices of a sharded leaf; the rest loads whole
    tp.load_full_state_dict(state.model, saved["params"])
    tp.load_full_optimizer_state(state.optimizer, saved["opt_state"])
    state.bundle.weights_changed()
    state.generator.set_state(saved["rng"])
    state.step = int(saved["step"])
    return state
