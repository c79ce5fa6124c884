"""Data-parallel training and rendering over ranks (port of
hyperreel_tpu/parallel/mesh.py; reference: PyTorch-Lightning DDP over
NCCL, main.py:174, 186-204).

One process per card, as `torchrun --nproc_per_node N -m
hyperreel_tpu_torch.main ... training.data_parallel=true` starts them:
`initialize_multihost` joins the process group (NCCL on the card, gloo on
the CPU) and puts each rank on cuda:LOCAL_RANK. The JAX package runs one
program over a mesh and shards one global batch; here every rank draws
that same global batch from the same seeded iterator and takes its own
rows (`shard_batch`). Its loss is the mean over its rows; the gradients
are all-reduced and averaged before the hand-written optimizer
(train/optim.py), so the update is the one-card step's on the global
batch, to the order of the sums, and a params-only term (the TV
regularizer) counts once. A per-ray random draw (StepCtx.uniform with
`per_ray`) is taken for the global batch and sliced, so each rank's
generator stays in step with the one-card step's. Grid events run on
every rank from the same params. Unlike the reference, a rank's
iteration is not skewed by its rank (its `train_iter += global_rank`).

`make_sharded_render` splits the rays of an eval call across the ranks
and gathers the outputs. The collectives are all-reduces and broadcasts,
which gloo also takes on CUDA tensors.
"""

import os

import torch
import torch.distributed as dist

from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.train.optim import tree_leaves
from hyperreel_tpu_torch.train.trainer import TrainState


def initialize_multihost(device=None, backend=None, init_method="env://",
                         world_size=None, rank=None):
    """Join the process group (a no-op where it is already joined) ->
    (rank, world size). By default from the environment torchrun sets
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); `init_method`
    ("tcp://localhost:<port>"), `world_size` and `rank` name them
    otherwise. The backend is NCCL for a CUDA `device`, gloo else; a CUDA
    device becomes the process's current device."""
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kwargs = {}
        if world_size is not None:
            kwargs = {"world_size": int(world_size), "rank": int(rank)}
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def rank_device(device="cuda"):
    """`device`, with the bare "cuda" taken as cuda:LOCAL_RANK under a
    launcher that sets LOCAL_RANK (torchrun)."""
    if str(device) == "cuda" and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device(device)


def host_shard_seed(seed):
    """A per-rank seed (the JAX package's per-host data seed); the
    training batches do not use it: every rank draws the global batch."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(seed) * 1000003 + rank


def shard_range(n, rank, world):
    """This rank's rows lo:hi of n; n must divide by the world size, as
    the JAX mesh needs the batch to."""
    if n % world:
        raise ValueError(f"a batch of {n} rays does not split over "
                         f"{world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per


def shard_batch(batch, rank, world):
    """This rank's rows of a global batch (a dict of arrays or tensors
    with the rays on axis 0)."""
    lo, hi = shard_range(len(batch["rays"]), rank, world)
    return {k: v[lo:hi] for k, v in batch.items()}


def replicate(tree, src=0):
    """Broadcast every tensor of the nested dict `tree` from rank `src`,
    in place, in the order of their paths (a rank's insertion order may
    differ); returns the tree."""
    for _, leaf in sorted(tree_leaves(tree), key=lambda pl: pl[0]):
        if not torch.is_tensor(leaf):
            continue
        buf = leaf if leaf.is_contiguous() else leaf.contiguous()
        dist.broadcast(buf, src)
        if buf is not leaf:
            leaf.copy_(buf)
    return tree


def all_reduce_mean(tensors):
    """The mean over the ranks of each tensor of the list, as new tensors
    (one all-reduce of their concatenation)."""
    world = dist.get_world_size()
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


class ShardedTrainer:
    """A Trainer's steps over the ranks of the process group: `step` on
    the rank's rows of a global batch with the averaged gradients, `run`
    one segment, `fit` across the grid events (Trainer.fit's loop)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    def place_state(self, state):
        """Every rank's state set to rank 0's (params and moments)."""
        replicate(state.params)
        replicate(state.opt_state["slots"])
        return state

    def step_ctx(self, it, n, gen=None, draws=None):
        lo, hi = shard_range(n, self.rank, self.world)
        return StepCtx(it=it, training=True, gen=gen,
                       draws=dict(draws or {}), ray_shard=(lo, hi, n))

    def grads(self, params, batch, it, gen=None, draws=None):
        """(metrics over the global batch, {path: gradient averaged over
        the ranks}) of the global `batch` at `it`."""
        tr = self.trainer
        local = tr.to_device(shard_batch(batch, self.rank, self.world))
        ctx = self.step_ctx(it, len(batch["rays"]), gen, draws)
        _, metrics, grads = tr.grads(params, local, ctx)
        paths = sorted(grads)
        mse = 10.0 ** (-metrics["psnr"] / 10.0)
        red = all_reduce_mean([grads[p] for p in paths] + [torch.stack(
            [metrics["loss"], metrics["image_loss"], mse])])
        loss, image_loss, mse = red[-1]
        metrics = {"loss": loss, "image_loss": image_loss,
                   "psnr": -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))}
        return metrics, dict(zip(paths, red[:-1]))

    def step(self, state, batch, optimizer, gen=None, draws=None):
        """One optimizer step at state.it on the global `batch` (numpy
        arrays or tensors, on any device) -> (the new state, the global
        batch's metrics)."""
        metrics, grads = self.grads(state.params, batch, state.it, gen,
                                    draws)
        opt_state = optimizer.step(state.params, grads, state.opt_state)
        return TrainState(state.params, opt_state, state.it + 1), metrics

    def run(self, state, batch_iter, num_iters, gen=None, draws=None):
        """`num_iters` steps of one segment (no grid event inside) ->
        (state, the last step's metrics)."""
        optimizer = self.trainer.make_optimizer(state.params)
        metrics = None
        for _ in range(num_iters):
            state, metrics = self.step(state, next(batch_iter), optimizer,
                                       gen, draws(state.it) if draws
                                       else None)
        return state, metrics

    def fit(self, state, batch_iter, num_iters, gen=None, log_every=0,
            callback=None, draws=None):
        """Trainer.fit with every step data-parallel: the same segments,
        grid events (on every rank, host-side) and log points."""
        return self.trainer.fit(state, batch_iter, num_iters, gen=gen,
                                log_every=log_every, callback=callback,
                                draws=draws, step=self.step)


def make_sharded_render(model):
    """render(params, rays, it, render_kwargs=None) -> outputs: the eval
    forward with the rays split across the ranks (the last ray repeated
    to a multiple of the world size), each rank rendering its rows, the
    per-ray outputs gathered on every rank (by one all-reduce of each
    rank's rows in place in zeros) and 0-d outputs (the witnesses) reduced
    by their maximum."""
    def render(params, rays, it, render_kwargs=None):
        rank, world = dist.get_rank(), dist.get_world_size()
        n = rays.shape[0]
        per = -(-n // world)
        if per * world != n:
            rays = torch.cat([rays, rays[-1:].expand(per * world - n,
                                                     *rays.shape[1:])])
        lo, hi = rank * per, (rank + 1) * per
        with torch.no_grad():
            out = model.apply(params, rays[lo:hi], StepCtx(it=it),
                              render_kwargs)
        gathered = {}
        for k, v in out.items():
            if v.ndim == 0:
                v = v.float().clone()
                dist.all_reduce(v, op=dist.ReduceOp.MAX)
                gathered[k] = v
                continue
            full = v.new_zeros((per * world,) + tuple(v.shape[1:]),
                               dtype=torch.float32)
            full[lo:hi] = v
            dist.all_reduce(full)
            gathered[k] = full[:n].to(v.dtype)
        return gathered

    return render
