"""The config system of the port (hyperreel_tpu_torch/config.py,
configs/reference_yaml.py) against the JAX package's: load_config +
apply_overrides + resolve_model_cfg give equal dicts for every ported
preset and its tiny version, with and without dotted overrides, and for a
reference yaml tree that the test writes (through `experiment/model=` and
`ref:`); the port has every preset of the JAX package."""

import os

import pytest
import yaml

from hyperreel_tpu import config as JC
from hyperreel_tpu.configs import reference_yaml as JR
from hyperreel_tpu_torch import config as TC
from hyperreel_tpu_torch.configs import reference_yaml as TR

PORTED = ["technicolor_z_plane", "llff_z_plane", "donerf_cylinder",
          "catacaustics_distance", "donerf_sphere", "immersive_sphere_new",
          "neural_3d_z_plane", "stanford_llff_z_plane", "shiny_z_plane",
          "tiny_static", "tiny_dynamic", "tiny_donerf_sphere",
          "tiny_immersive_sphere", "tiny_neural_3d", "tiny_stanford_llff",
          "tiny_shiny", "tiny_donerf_cylinder",
          "tiny_catacaustics_distance", "technicolor_cascaded",
          "blender_voxel", "shiny_z_deformable", "refnerf_sphere",
          "refnerf_sphere_reflect", "tiny_cascaded", "tiny_blender_voxel",
          "tiny_shiny_deformable", "tiny_refnerf_reflect"]
# the port's tiny RGB and primitive presets keep bf16 tables (its fused
# routes need them; tests/test_torch_package.py), where the JAX package's
# turn them off
BF16_TINY = ("tiny_stanford_llff", "tiny_shiny", "tiny_donerf_sphere",
             "tiny_donerf_cylinder", "tiny_catacaustics_distance",
             "tiny_immersive_sphere", "tiny_shiny_deformable",
             "tiny_refnerf_reflect")
OVERRIDES = ["training.batch_size=8192", "training.num_iters=200",
             "dataset.name=llff", "dataset.root_dir=/data/fern",
             "dataset.use_raystore=true",
             "model.color.net.upsamp_list=[300,6000]",
             "model.color.net.update_AlphaMask_list=[200]",
             "model.color.net.alpha_mask_thre=1e-2",
             "params.compute_dtype=bfloat16"]


def _jax_like(name, model_cfg):
    if name in BF16_TINY:
        model_cfg["color"]["net"]["bf16_tables"] = True
    return model_cfg


def _both(overrides, path=None, ipe=4000):
    j = JC.load_config(path, overrides)
    t = TC.load_config(path, overrides)
    return j, t, JC.resolve_model_cfg(j, ipe), TC.resolve_model_cfg(t, ipe)


@pytest.mark.parametrize("dotted", [False, True])
@pytest.mark.parametrize("name", PORTED)
def test_presets_resolve_as_in_jax(name, dotted):
    ov = [f"model={name}"] + (OVERRIDES if dotted else [])
    j, t, jm, tm = _both(ov)
    assert t == j
    assert tm == _jax_like(name, jm)
    if dotted:
        assert t["model"]["preset"] == name
        net = tm["color"]["net"]
        assert net["upsamp_list"] == [300, 6000]
        assert net["update_AlphaMask_list"] == [200]
        assert t["dataset"]["use_raystore"] is True
        assert t["training"]["batch_size"] == 8192


def test_default_and_file_config_as_in_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({
        "model": "tiny_dynamic",
        "dataset": {"name": "synthetic_blobs", "n_views": 2,
                    "wh": [8, 8]},
        "training": {"num_iters": 10, "optimizers": {"color": {"lr": 0.5}}},
        "regularizers": {"tensorf": {"type": "tensorf",
                                     "TV_weight_density": 0.05}},
        "visualizers": {"epi": {"type": "epipolar", "v": 0.1}}}))
    for ov in ([], ["training.num_epochs=3", "experiment/model=tiny_static"]):
        j, t, jm, tm = _both(ov, str(path), ipe=50)
        assert t == j
        assert tm == jm
    assert TC.DEFAULT_TRAINING == JC.DEFAULT_TRAINING
    assert TC.deep_update({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}}) == \
        JC.deep_update({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}})
    for s in ("[1, 2]", "true", "1e-2", "abc", "{a: 1}", "a: b: c"):
        assert TC._parse_value(s) == JC._parse_value(s)
    with pytest.raises(ValueError):
        TC.apply_overrides({}, ["no_equals"])


def _write_ref_tree(root):
    d = os.path.join(root, "experiment", "model")
    os.makedirs(d)
    cfg = JC.MODEL_PRESETS["tiny_static"]()
    cfg["render"] = {"type": "dropped"}
    with open(os.path.join(d, "my_static.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    # a name that is also a preset: `ref:` forces the yaml
    cfg = JC.MODEL_PRESETS["tiny_dynamic"]()
    cfg["color"]["net"]["aabb"] = [[-3.0, -3.0, -1.0], [3.0, 3.0, 1.0]]
    with open(os.path.join(d, "tiny_dynamic.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    open(os.path.join(d, "empty.yaml"), "w").close()


def test_reference_yaml_tree_as_in_jax(tmp_path, monkeypatch):
    _write_ref_tree(str(tmp_path))
    for mod in (JR, TR):
        monkeypatch.setattr(mod, "DEFAULT_CONF_DIR", str(tmp_path))
    assert TR.list_reference_models() == JR.list_reference_models() == \
        ["empty", "my_static", "tiny_dynamic"]
    for ov in (["experiment/model=my_static"], ["model=ref:tiny_dynamic"],
               ["experiment/model=my_static",
                "model.color.net.alpha_mask_thre=0.5"],
               ["experiment/model=tiny_dynamic"]):
        j, t, jm, tm = _both(ov, ipe=50)
        assert t == j
        assert tm == jm
        assert "render" not in tm
    _, _, _, tm = _both(["model=ref:tiny_dynamic"])
    assert tm["color"]["net"]["aabb"][0][0] == -3.0
    for mod in (JR, TR):
        with pytest.raises(ValueError):
            mod.reference_model_cfg("empty")
        with pytest.raises(FileNotFoundError):
            mod.reference_model_cfg("missing")


def test_every_jax_preset_is_ported_or_named():
    assert set(TC.MODEL_PRESETS) == set(PORTED)
    assert set(JC.MODEL_PRESETS) == set(PORTED)
    cfg = TC.load_config(overrides=["model=no_such_model"])
    with pytest.raises(KeyError):
        TC.resolve_model_cfg(cfg, 4000)
