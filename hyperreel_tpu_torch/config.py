"""The default training configuration (port of hyperreel_tpu/config.py
DEFAULT_TRAINING: the batch, the loss and the four optimizer groups of
the reference's conf/experiment/training/*_tensorf.yaml). The rest of that
module, the YAML config system and the CLI overrides, is not ported
(ROADMAP.md: render CLI and viewer)."""

DEFAULT_TRAINING = {
    "batch_size": 16384,
    "ray_chunk": 262144,
    # k steps per call of the JAX package's lax.scan; the port runs them
    # one by one (train/trainer.py)
    "steps_per_call": 8,
    "num_iters": 4000,
    "num_epochs": 40,
    "val_every": 10,
    "render_every": 40,
    "ckpt_every": 40,
    "log_every": 100,
    "sample_with_replacement": True,
    "loss": {"type": "mse"},
    "optimizers": {
        "color": {
            "optimizer": "adam", "lr": 0.02, "lr_scheduler": "exp",
            "decay_epoch": 100, "decay_gamma": 0.125, "warmup_epochs": 0,
            "reset_opt_list": [4000, 6000, 8000, 10000, 12000],
        },
        "color_impl": {
            "optimizer": "adam", "lr": 0.001, "lr_scheduler": "exp",
            "decay_epoch": 100, "decay_gamma": 0.125, "warmup_epochs": 0,
            "reset_opt_list": [4000, 6000, 8000, 10000, 12000],
        },
        "embedding": {
            "optimizer": "adam", "lr": 0.01, "lr_scheduler": "exp",
            "decay_epoch": 100, "decay_gamma": 0.125, "warmup_epochs": 0,
            "reset_opt_list": [4000, 6000, 8000, 10000, 12000],
        },
        "embedding_impl": {
            "optimizer": "adam", "lr": 0.00075, "lr_scheduler": "exp",
            "decay_epoch": 100, "decay_gamma": 0.125, "warmup_epochs": 0,
            "reset_opt_list": [4000, 6000, 8000, 10000, 12000],
        },
    },
}
