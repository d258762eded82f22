"""Checkpoints of the training state; port of ``rpst.train.checkpoint``.

One ``torch.save`` per checkpoint, ``<root>/<step>/state.pt``, holding
``{step, params, opt_state, rng}``: the model's state_dict (parameters
and buffers: sel_multi_adain's BatchNorm running statistics), the Adam
state_dict (moments and count), and the ``torch.Generator`` state. The
step is stored in the file and mirrored in the directory name. Restoring
all of it makes a resumed run continue the same computation.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(root, state) -> str:
    """Write ``<root>/<state.step>/state.pt``; returns the directory."""
    path = Path(root).resolve() / str(state.step)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{STATE_FILE}.tmp"
    torch.save({"step": state.step,
                "params": state.model.state_dict(),
                "opt_state": state.optimizer.state_dict(),
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
    state.bundle.load_state_dict(saved["params"])
    state.optimizer.load_state_dict(saved["opt_state"])
    state.generator.set_state(saved["rng"])
    state.step = int(saved["step"])
    return state
