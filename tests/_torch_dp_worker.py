"""One rank of the two-process data-parallel run of
tests/test_torch_parallel.py, on the CPU over gloo:

    python tests/_torch_dp_worker.py SETUP OUT RANK WORLD PORT

SETUP is a torch.save'd dict: the model config and dataset_info, the
training config, the weights (the JAX layout, numpy), the global batches,
each step's injected draws and the rays of a render. The rank writes to
OUT/rank<RANK>.pt the averaged gradients of the first step, the params
after the steps and the sharded render's rgb; then both ranks train a
System with training.data_parallel=true under OUT/system (only rank 0
may write there).
"""

import os
import sys

import torch


def main(setup, out, rank, world, port):
    from hyperreel_tpu_torch.convert import params_from_jax
    from hyperreel_tpu_torch.main import main as cli
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.parallel.mesh import (
        ShardedTrainer, initialize_multihost, make_sharded_render)
    from hyperreel_tpu_torch.train.trainer import Trainer, TrainState

    torch.set_num_threads(1)
    initialize_multihost("cpu", init_method=f"tcp://localhost:{port}",
                         world_size=world, rank=rank)
    s = torch.load(setup, weights_only=False)
    model = build_model(s["cfg"], dataset_info=s["info"])
    trainer = Trainer(model, s["training"], regularizer_cfgs=s["regs"],
                      iters_per_epoch=s["ipe"], device="cpu")
    # rank 1 starts from other weights: place_state gives it rank 0's
    params = params_from_jax(s["weights"], device="cpu")
    if rank:
        params = trainer.init_state(torch.Generator().manual_seed(9)).params
    state = TrainState(params, trainer.make_optimizer(params).init(params),
                       0)
    sharded = ShardedTrainer(trainer)
    state = sharded.place_state(state)
    _, grads0 = sharded.grads(state.params, s["batches"][0], 0,
                              draws=s["draws"][0])
    state, _ = sharded.run(state, iter(s["batches"]), len(s["batches"]),
                           draws=lambda it: s["draws"][it])
    render = make_sharded_render(model)
    rgb = render(state.params, torch.from_numpy(s["render_rays"]),
                 s["it"])["rgb"]
    torch.save({"grads0": grads0, "params": state.params, "rgb": rgb},
               os.path.join(out, f"rank{rank}.pt"))
    cli(["--device", "cpu", f"params.save_dir={out}", "params.name=system",
         "training.data_parallel=true"] + s["cli"])
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         int(sys.argv[5]))
