"""Config system (port of hyperreel_tpu/config.py; reference: the Hydra
tree under conf/, SURVEY.md section 5).

Hydra is not a dependency; this keeps the same surface with PyYAML:
config groups (params / dataset / model / training / regularizers /
visualizers), `a.b.c=value` overrides, plain YAML files. A model entry
names one of the port's presets (configs/presets.py) or a reference yaml
(configs/reference_yaml.py), or is spelled out inline. The port has
every preset of the JAX package.
"""

import copy
from typing import List, Optional

import yaml

from hyperreel_tpu_torch.configs import presets

DEFAULT_TRAINING = {
    "batch_size": 16384,
    # the render chunk (train/render.py)
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

MODEL_PRESETS = {
    "technicolor_z_plane": presets.technicolor_z_plane,
    "llff_z_plane": presets.llff_z_plane,
    "donerf_cylinder": presets.donerf_cylinder,
    "blender_voxel": presets.blender_voxel,
    "catacaustics_distance": presets.catacaustics_distance,
    "shiny_z_deformable": presets.shiny_z_deformable,
    "donerf_sphere": presets.donerf_sphere,
    "immersive_sphere_new": presets.immersive_sphere_new,
    "neural_3d_z_plane": presets.neural_3d_z_plane,
    "technicolor_cascaded": presets.technicolor_cascaded,
    "stanford_llff_z_plane": presets.stanford_llff_z_plane,
    "shiny_z_plane": presets.shiny_z_plane,
    "refnerf_sphere": presets.refnerf_sphere,
    "refnerf_sphere_reflect": presets.refnerf_sphere_reflect,
    "tiny_refnerf_reflect": presets.tiny_refnerf_reflect,
    "tiny_static": presets.tiny_static,
    "tiny_dynamic": presets.tiny_dynamic,
    "tiny_donerf_sphere": presets.tiny_donerf_sphere,
    "tiny_immersive_sphere": presets.tiny_immersive_sphere,
    "tiny_neural_3d": presets.tiny_neural_3d,
    "tiny_cascaded": presets.tiny_cascaded,
    "tiny_stanford_llff": presets.tiny_stanford_llff,
    "tiny_shiny": presets.tiny_shiny,
    "tiny_donerf_cylinder": presets.tiny_donerf_cylinder,
    "tiny_blender_voxel": presets.tiny_blender_voxel,
    "tiny_catacaustics_distance": presets.tiny_catacaustics_distance,
    "tiny_shiny_deformable": presets.tiny_shiny_deformable,
}


def deep_update(base, override):
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(s):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def apply_overrides(cfg, overrides: Optional[List[str]]):
    """Hydra-style dotted overrides: `training.batch_size=8192`.

    Dotted paths under a preset-named model (`model=technicolor_z_plane
    model.color.net.upsamp_list=[150]`) wrap the name into
    `{"preset": name, "overrides": {...}}` so resolve_model_cfg applies
    them on top of the preset.

    The reference's group-selection syntax `experiment/model=X`
    (reference conf/experiment/local.yaml:3-9) selects the preset named X
    when there is one, else the reference's own
    conf/experiment/model/X.yaml (configs/reference_yaml.py); `ref:X`
    model names force the yaml.
    """
    cfg = copy.deepcopy(cfg)
    for ov in overrides or []:
        if ov.startswith("experiment/model="):
            cfg["model"] = ov.split("=", 1)[1]
            continue
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov}")
        key, val = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                if p == "model" and isinstance(nxt, str):
                    nxt = {"preset": nxt, "overrides": {}}
                else:
                    nxt = {}
                node[p] = nxt
            if p == "model" and "preset" in nxt:
                nxt = nxt.setdefault("overrides", {})
            node = nxt
        node[parts[-1]] = _parse_value(val)
    return cfg


def load_config(path=None, overrides=None):
    cfg = {
        "params": {"seed": 0, "save_dir": "runs", "name": "experiment"},
        "dataset": {"name": "synthetic_blobs"},
        "model": "tiny_static",
        "training": copy.deepcopy(DEFAULT_TRAINING),
        "regularizers": {},
    }
    if path:
        with open(path) as f:
            file_cfg = yaml.safe_load(f) or {}
        cfg = deep_update(cfg, file_cfg)
    cfg = apply_overrides(cfg, overrides)
    return cfg


def resolve_model_cfg(cfg, iters_per_epoch):
    """Turn the config's `model` entry (preset name or inline dict) into a
    fully resolved model dict with epoch->iter conversion applied."""
    model = cfg["model"]
    if isinstance(model, str):
        model_cfg = _named_model_cfg(model)
    elif isinstance(model, dict) and "preset" in model:
        model_cfg = _named_model_cfg(model["preset"])
        model_cfg = deep_update(model_cfg, model.get("overrides", {}))
    else:
        model_cfg = copy.deepcopy(model)
    return presets.convert_epochs_to_iters(model_cfg, iters_per_epoch)


def _named_model_cfg(name):
    """Resolve a model name: a preset first, then the reference's own
    conf/experiment/model/<name>.yaml (`ref:` prefix forces the yaml)."""
    from hyperreel_tpu_torch.configs import reference_yaml
    if name.startswith("ref:"):
        return reference_yaml.reference_model_cfg(name[4:])
    if name in MODEL_PRESETS:
        return MODEL_PRESETS[name]()
    if reference_yaml.reference_conf_available():
        return reference_yaml.reference_model_cfg(name)
    raise KeyError(
        f"unknown model '{name}': not a preset and no reference conf dir")
