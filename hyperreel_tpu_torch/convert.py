"""Weights bridge between the JAX package's params pytree and the port's.

The trees have the same nesting (`model.init`'s layout). Dense layers
differ: JAX stores {"w": [in, out], "b": [out]}, the port the nn.Linear
layout {"weight": [out, in], "bias": [out]}. Grids stay channels-last in
both. A list of leaves on the JAX side (TensorCP's lines) is a dict keyed
"0", "1", ... in the port. Leaves on the JAX side are numpy arrays
(np.asarray of the jax arrays); nothing here imports jax.
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
    if isinstance(tree, (list, tuple)):
        return {str(i): params_from_jax(v, device) for i, v in enumerate(tree)}
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def _is_port_list(node):
    return isinstance(node, dict) and len(node) > 0 \
        and list(node) == [str(i) for i in range(len(node))]


def params_to_jax(params):
    """The port's params -> the JAX layout, as numpy arrays."""
    if _is_port_linear(params):
        out = {"w": params["weight"].detach().cpu().numpy().T.copy()}
        if "bias" in params:
            out["b"] = params["bias"].detach().cpu().numpy()
        return out
    if _is_port_list(params):
        return [params_to_jax(params[str(i)]) for i in range(len(params))]
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def _jax_leaf(tree, path):
    """The JAX tree's leaf at the port's path (a dense layer's "weight"
    is the transposed "w", its "bias" the "b")."""
    for k in path:
        if k == "weight":
            return np.asarray(tree["w"], np.float32).T
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) \
            else tree["b" if k == "bias" else k]
    return np.asarray(tree, np.float32)


def opt_state_from_jax(state, labels, device="cuda"):
    """The JAX trainer's optax state (hyperreel_tpu/train/optim.py
    build_optimizer: a multi_transform, each group's chain of optax
    states, numpy leaves) -> the port's GroupedOptimizer state for params
    labelled `labels` (model.param_groups): each group's counter and
    each leaf's moments (adam "mu"/"nu", sgd "trace", rmsprop "nu"), on
    `device`, the card unless the caller names another."""
    from hyperreel_tpu_torch.train.optim import path_key, tree_leaves

    count, moments = {}, {}
    for label, masked in state.inner_states.items():
        for sub in masked.inner_state:
            fields = getattr(sub, "_fields", ())
            if "count" in fields:
                count[label] = int(sub.count)
            for name in ("mu", "nu", "trace"):
                if name in fields:
                    moments.setdefault(label, {})[name] = getattr(sub, name)
    slots = {}
    for path, label in tree_leaves(labels):
        slots[path_key(path)] = {
            name: torch.tensor(_jax_leaf(tree, path), device=device)
            for name, tree in moments.get(label, {}).items()}
    return {"count": count, "slots": slots}
