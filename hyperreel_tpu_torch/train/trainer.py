"""Training loop with grid events (port of hyperreel_tpu/train/trainer.py;
reference nlf/__init__.py INRSystem and TensorBase.set_iter's grid events).

A step: the model's general chain in training (`ctx.training`; no fused
route, as in the JAX package), the weighted image loss and the
regularizers, the gradient of every param leaf by autograd (the grid
lookups through their hand-made backward, ops/grid_sample.py), then the
grouped optimizer (train/optim.py) in place. The iteration `it` stays a
host int, so the schedules (ease windows, learning rates, the L1 switch,
the TV cutoff) are evaluated on the host; a step's random draws come from
the trainer's torch.Generator, or from `draws(it)` where a caller injects
them (a test gives the JAX package's).

Grid events (the alpha-mask update with its shrink at the first, the
upsamples at `upsamp_list`) run on the host between segments; the
optimizer state is then initialized anew, so each group's counter starts
again from 0 (train/optim.py).

`steps_per_call` runs its steps in a loop with the same iterations and the
same log points: the JAX package's `lax.scan` over k steps per device call
is a TPU dispatch device with no counterpart here, as are its compiled-step
cache and `params_fingerprint` (torch runs eagerly and compiles nothing per
shape).
"""

from dataclasses import dataclass

import numpy as np
import torch

from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.tensorf import n_to_reso
from hyperreel_tpu_torch.train.losses import get_loss
from hyperreel_tpu_torch.train.optim import (
    apply_weight_init, build_optimizer, tree_leaves)
from hyperreel_tpu_torch.train.regularizers import build_regularizers


def _requiring_grad(tree):
    """A copy of the nested dict `tree` whose leaves are detached views of
    its tensors that require grad."""
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_()


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    it: int   # host-side integer


class Trainer:
    """Single-model trainer with segment-based grid events, on `device`
    (the card unless the caller names the CPU)."""

    def __init__(self, model, training_cfg, regularizer_cfgs=None,
                 iters_per_epoch=4000, device="cuda"):
        self.model = model
        self.training_cfg = training_cfg
        self.iters_per_epoch = iters_per_epoch
        self.device = torch.device(device)
        self.loss_fn = get_loss(training_cfg.get("loss", {"type": "mse"}))
        self.regularizers = build_regularizers(regularizer_cfgs)
        self.optimizers_cfg = training_cfg["optimizers"]
        net = model.color_net
        self.upsamp_list = list(net.upsamp_list)
        self.alpha_list = list(net.update_alphamask_list)
        self.n_voxel_list = list(net.n_voxel_list)

    # -- state -------------------------------------------------------------

    def init_state(self, gen, it=0):
        """Params drawn from the torch.Generator `gen`, a fresh optimizer
        state."""
        params = self.model.init(gen, self.device)
        wi = self.training_cfg.get("weight_init")
        if wi and wi.get("type", "none") != "none":
            params = apply_weight_init(params, wi, gen)
        return TrainState(params, self.make_optimizer(params).init(params),
                          it)

    def make_optimizer(self, params):
        return build_optimizer(self.optimizers_cfg,
                               self.model.param_groups(params),
                               self.iters_per_epoch)

    def to_device(self, batch):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    # -- the step ------------------------------------------------------------

    def loss_and_metrics(self, params, batch, ctx):
        """(the total loss, {"loss", "image_loss", "psnr"}) of one batch."""
        out = self.model.apply(params, batch["rays"], ctx)
        rgb = out["rgb"]
        target = batch["rgb"]
        weights = batch.get("weights")
        if weights is not None:
            image_loss = self.loss_fn(rgb * weights, target * weights)
        else:
            image_loss = self.loss_fn(rgb, target)
        total = image_loss
        for _, reg in self.regularizers:
            total = total + reg.loss(self.model, params, batch, ctx)
        mse = ((rgb - target) ** 2).mean()
        psnr = -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
        return total, {"loss": total, "image_loss": image_loss, "psnr": psnr}

    def forward(self, params, batch, ctx):
        """(the total loss, metrics, [(path, leaf)]) of one batch, recorded
        for backward on detached copies of the param leaves that require
        grad: the caller's params stay plain tensors, so that a model
        applied to them outside a step records nothing."""
        params = _requiring_grad(params)
        total, metrics = self.loss_and_metrics(params, batch, ctx)
        return total, metrics, tree_leaves(params)

    @staticmethod
    def backward(total, leaves):
        """{path: gradient} of `total` for the leaves that forward gave; a
        leaf the loss does not reach gets a zero gradient, as under
        jax.value_and_grad."""
        gs = torch.autograd.grad(total, [leaf for _, leaf in leaves],
                                 allow_unused=True)
        return {path: torch.zeros_like(leaf) if g is None else g
                for (path, leaf), g in zip(leaves, gs)}

    def grads(self, params, batch, ctx):
        """(the total loss, metrics, {path: gradient}) of one batch."""
        total, metrics, leaves = self.forward(params, batch, ctx)
        grads = self.backward(total, leaves)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    @staticmethod
    def step_ctx(it, gen=None, draws=None):
        """The StepCtx of the training step at `it` (on a copy of `draws`,
        which the step's own draws join)."""
        return StepCtx(it=it, training=True, gen=gen, draws=dict(draws or {}))

    def step(self, state, batch, optimizer, gen=None, draws=None):
        """One optimizer step at state.it on a device batch -> (the new
        state, its metrics); `draws` the injected random draws of this
        step (StepCtx.draws). The optimizer updates state.params in
        place."""
        _, metrics, grads = self.grads(
            state.params, batch, self.step_ctx(state.it, gen, draws))
        opt_state = optimizer.step(state.params, grads, state.opt_state)
        return TrainState(state.params, opt_state, state.it + 1), metrics

    # -- host-side grid events (reference tensorf_base.py:509-553) ---------

    def pending_events(self, start_it, end_it):
        """Event iterations in (start_it, end_it]."""
        return sorted(set(
            [i for i in self.upsamp_list if start_it < i <= end_it]
            + [i for i in self.alpha_list if start_it < i <= end_it]))

    def apply_event(self, state, it):
        """TensorBase.set_iter at iteration `it`: the alpha-mask update
        (with the shrink to the occupied box at the first), then the
        upsample to the scheduled voxel count over the (new) aabb, then a
        fresh optimizer state."""
        net = self.model.color_net
        params = state.params
        changed = False
        if it in self.alpha_list:
            reso = tuple(min(g, 200) for g in net.grid_size)
            # the occupancy mask itself is not kept: nothing reads it (the
            # JAX package stores it and reads it nowhere either)
            new_aabb = net.compute_alpha_grid(params["color"], reso)[1]
            new_aabb = new_aabb.cpu().numpy()
            if it == self.alpha_list[0] and np.all(np.isfinite(new_aabb)):
                params = dict(params,
                              color=net.shrink(params["color"], new_aabb))
                changed = True
        if it in self.upsamp_list and self.n_voxel_list:
            n_voxels = self.n_voxel_list[self.upsamp_list.index(it)]
            params = dict(params, color=net.upsample(
                params["color"], n_to_reso(n_voxels, net.aabb)))
            changed = True
        # a shrink or an upsample resets the optimizer (the JAX package's
        # lr_upsample_reset only ever adds an upsample, which resets anyway)
        if changed:
            opt_state = self.make_optimizer(params).init(params)
        else:
            opt_state = state.opt_state
        return TrainState(params, opt_state, it)

    # -- the segment loop ----------------------------------------------------

    def fit(self, state, batch_iter, num_iters, gen=None, log_every=0,
            callback=None, draws=None, step=None):
        """Run `num_iters` steps from state.it across the grid events.
        `batch_iter` yields batches (dicts of numpy arrays or tensors);
        `gen` is the steps' torch.Generator (seed 0 on the trainer's device
        if None); `draws(it)`, where given, the injected draws of the step
        at `it`; `step(state, batch, optimizer, gen, draws)` takes each
        step from the iterator's batch (by default `self.step` on it
        copied to the device; parallel/mesh.py ShardedTrainer.step).
        Returns (state, history: one dict of floats with "it" at every
        multiple of log_every)."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        if step is None:
            def step(st, batch, opt, g, d):
                return self.step(st, self.to_device(batch), opt, g, d)
        end_it = state.it + num_iters
        history = []
        while state.it < end_it:
            events = self.pending_events(state.it, end_it)
            seg_end = events[0] if events else end_it
            optimizer = self.make_optimizer(state.params)
            while state.it < seg_end:
                state, metrics = step(
                    state, next(batch_iter), optimizer, gen,
                    draws(state.it) if draws else None)
                if log_every and state.it % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["it"] = state.it
                    history.append(m)
                    if callback:
                        callback(m)
            if events and state.it == seg_end:
                state = self.apply_event(state, seg_end)
        return state, history
