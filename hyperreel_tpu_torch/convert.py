"""Weights bridge between the JAX package's params pytree and the port's.

The trees have the same nesting (`model.init`'s layout). Dense layers
differ: JAX stores {"w": [in, out], "b": [out]}, the port the nn.Linear
layout {"weight": [out, in], "bias": [out]}. Grids stay channels-last in
both. Leaves on the JAX side are numpy arrays (np.asarray of the jax
arrays); nothing here imports jax.
"""

import numpy as np
import torch


def _is_jax_linear(node):
    return isinstance(node, dict) and "w" in node \
        and set(node) <= {"w", "b"}


def _is_port_linear(node):
    return isinstance(node, dict) and "weight" in node \
        and set(node) <= {"weight", "bias"}


def params_from_jax(tree, device="cuda"):
    """JAX params (numpy leaves) -> the port's params (f32 tensors on
    `device`, the card unless the caller names another)."""
    if _is_jax_linear(tree):
        out = {"weight": torch.tensor(
            np.asarray(tree["w"], np.float32).T, device=device)}
        if "b" in tree:
            out["bias"] = torch.tensor(np.asarray(tree["b"], np.float32),
                                       device=device)
        return out
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def params_to_jax(params):
    """The port's params -> the JAX layout, as numpy arrays."""
    if _is_port_linear(params):
        out = {"w": params["weight"].detach().cpu().numpy().T.copy()}
        if "bias" in params:
            out["b"] = params["bias"].detach().cpu().numpy()
        return out
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
