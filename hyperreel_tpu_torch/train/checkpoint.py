"""Checkpoint and resume (port of hyperreel_tpu/train/checkpoint.py;
reference main.py:106-157 and nlf/__init__.py:433-479).

The grid shapes change at the upsample and shrink events, so a checkpoint
carries the grid's resolution and aabb beside the iteration in
`meta.json` (the JAX package's file); the params and the optimizer state,
with its per-group counters, are in torch's own format (`params.pt`,
`opt_state.pt`). Restoring sets the net's host state (grid_size, aabb)
first, then loads the tensors onto the trainer's device.
"""

import json
import os

import numpy as np
import torch


def _meta_for(state, model):
    net = model.color_net
    return {"it": int(state.it),
            "grid_size": [int(g) for g in net.grid_size],
            "aabb": np.asarray(net.aabb).tolist()}


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(path, state, model):
    """Write meta.json, the params and the optimizer state under the
    directory `path`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(_meta_for(state, model), f)
    torch.save(_to_cpu(state.params), os.path.join(path, "params.pt"))
    torch.save(_to_cpu(state.opt_state), os.path.join(path, "opt_state.pt"))
    return path


def restore_checkpoint(path, trainer):
    """The TrainState of the checkpoint at `path` on the trainer's device,
    the net's grid_size and aabb set from its meta.json first. The tensors
    are loaded as saved: params that do not fit the net fail at the first
    step."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    net = trainer.model.color_net
    net.grid_size = list(meta["grid_size"])
    net.aabb = np.asarray(meta["aabb"], np.float32)
    dev = trainer.device
    params = torch.load(os.path.join(path, "params.pt"), map_location=dev)
    opt_state = torch.load(os.path.join(path, "opt_state.pt"),
                           map_location=dev)
    from hyperreel_tpu_torch.train.trainer import TrainState
    return TrainState(params, opt_state, int(meta["it"]))
