"""Ingestion of the reference's shipped Hydra model configs (a copy of
hyperreel_tpu/configs/reference_yaml.py, which the port keeps as its own).

The reference's experiment contract is `experiment/model=X` selecting
`conf/experiment/model/X.yaml` (reference conf/experiment/local.yaml:3-9).
Those yamls are interpolation-free plain dicts whose `type:` strings name
the registries the model constructors read, so ingestion is a YAML load plus
two normalizations:

  * `render:` is dropped: the rendering is the System's chunked
    renderer (train/render.py), not a config choice per model.
  * an empty yaml (the reference ships one, bom_z_plane.yaml) raises a
    clear error instead of returning None.

The conf directory is named by the environment variable
`HYPERREEL_REF_CONF` (the JAX package's variable) or passed as `conf_dir`;
with neither, no reference conf is available.
"""

import os

import yaml

DEFAULT_CONF_DIR = os.environ.get("HYPERREEL_REF_CONF")


def reference_conf_available(conf_dir=None):
    d = conf_dir or DEFAULT_CONF_DIR
    return bool(d) and os.path.isdir(os.path.join(d, "experiment", "model"))


def list_reference_models(conf_dir=None):
    d = os.path.join(conf_dir or DEFAULT_CONF_DIR, "experiment", "model")
    return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".yaml"))


def load_reference_model_yaml(path):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"empty or malformed reference model yaml: {path}")
    cfg.pop("render", None)
    return cfg


def reference_model_cfg(name, conf_dir=None):
    """Load `conf/experiment/model/<name>.yaml` as a model config dict."""
    d = conf_dir or DEFAULT_CONF_DIR
    if not d:
        raise FileNotFoundError(
            f"no reference model config '{name}': no conf directory (set "
            "HYPERREEL_REF_CONF)")
    path = os.path.join(d, "experiment", "model", name + ".yaml")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no reference model config '{name}' under {d} "
            f"(available: {', '.join(list_reference_models(d)[:8])} ...)")
    return load_reference_model_yaml(path)
