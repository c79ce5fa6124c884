"""The model configs that the port renders, as plain dicts: its own copy
of the parts of hyperreel_tpu/configs/presets.py it uses (the reference's
shipped Hydra yamls, conf/experiment/model/*.yaml).

`convert_epochs_to_iters` reproduces the reference's in-place epoch->iter
config rewrite (nlf/__init__.py:306-315, utils/config_utils.py:32-38):
every `*_epoch(s)` key becomes the matching `*_iter(s)` key scaled by
iters_per_epoch. tests/test_torch_package.py holds each preset here equal
to the JAX package's.
"""

import copy

_EPOCH_KEY_MAP = {
    "max_freq_epoch": "max_freq_iter",
    "wait_epochs": "wait_iters",
    "window_epochs": "window_iters",
    "stop_epochs": "stop_iters",
    "warmup_epochs": "warmup_iters",
    "decay_epochs": "decay_iters",
    "falloff_epochs": "falloff_iters",
}


def convert_epochs_to_iters(cfg, iters_per_epoch):
    """Recursively rewrite epoch-denominated schedule keys to iterations."""
    if isinstance(cfg, dict):
        out = {}
        for k, v in cfg.items():
            if k in _EPOCH_KEY_MAP and isinstance(v, (int, float)):
                out[_EPOCH_KEY_MAP[k]] = v * iters_per_epoch
            else:
                out[k] = convert_epochs_to_iters(v, iters_per_epoch)
        return out
    if isinstance(cfg, list):
        return [convert_epochs_to_iters(v, iters_per_epoch) for v in cfg]
    return cfg


def _ease_sigmoid(window_epochs, wait_epochs, shift=4.0):
    return {
        "type": "ease_value",
        "start_value": 1.0,
        "window_epochs": window_epochs,
        "wait_epochs": wait_epochs,
        "activation": {"type": "sigmoid", "shift": shift},
    }


def _ease_zero():
    return {
        "type": "ease_value",
        "start_value": 0.0,
        "window_epochs": 0,
        "wait_epochs": 0,
        "activation": {"type": "identity"},
    }


def technicolor_z_plane(z_channels=32):
    """Dynamic HyperReel model (reference
    conf/experiment/model/technicolor_z_plane.yaml)."""
    return {
        "type": "lightfield",
        "param": {"n_dims": 6, "fn": "identity"},
        "embedding": {
            "type": "ray_point",
            "embeddings": {
                "ray_prediction_0": {
                    "type": "ray_prediction",
                    "params": {
                        "ray": {
                            "start": 0, "end": 6,
                            "param": {"n_dims": 4, "fn": "two_plane"},
                            "pe": {"type": "windowed", "n_freqs": 0,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                        "time": {
                            "start": 7, "end": 8,
                            "param": {"n_dims": 1, "fn": "identity"},
                            "pe": {"type": "windowed", "n_freqs": 2,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                    },
                    "net": {"type": "base", "group": "embedding_impl",
                            "depth": 6, "hidden_channels": 256, "skips": [3]},
                    "z_channels": z_channels,
                    "outputs": {
                        "z_vals": {"channels": 1},
                        "spatial_flow": {
                            "channels": 3,
                            "activation": {"type": "identity",
                                           "outer_fac": 0.25},
                        },
                        "sigma": {"channels": 1,
                                  "activation": _ease_sigmoid(3, 0)},
                        "point_sigma": {"channels": 1,
                                        "activation": _ease_sigmoid(3, 1)},
                        "point_offset": {
                            "channels": 3,
                            "activation": {"type": "tanh", "outer_fac": 0.25},
                        },
                        "color_scale": {"channels": 3,
                                        "activation": _ease_zero()},
                        "color_shift": {"channels": 3,
                                        "activation": _ease_zero()},
                    },
                },
                "ray_intersect_0": {
                    "type": "ray_intersect",
                    "z_channels": z_channels,
                    "intersect": {
                        "type": "z_plane",
                        "sort": True,
                        "use_disparity": False,
                        "use_sigma": True,
                        "out_points": "raw_points",
                        "out_distance": "raw_distance",
                        "initial": -1.0,
                        "end": 1.0,
                        "activation": {"type": "identity", "fac": 0.5},
                    },
                },
                "flow_0": {
                    "type": "advect_points",
                    "use_spatial_flow": True,
                    "use_angular_flow": False,
                    "out_flow_field": "raw_flow",
                    "flow_scale": 0.0,
                    "spatial_flow_activation": {"type": "identity",
                                                "fac": 0.25},
                },
                "point_offset_0": {
                    "type": "point_offset",
                    "in_density_field": "point_sigma",
                    "use_sigma": True,
                },
                "add_point_outputs_0": {
                    "type": "add_point_outputs",
                    "extra_outputs": ["viewdirs", "times"],
                },
                "extract_fields": {
                    "type": "extract_fields",
                    "fields": ["points", "distances", "base_times",
                               "time_offset", "times", "viewdirs", "weights",
                               "color_transform_global", "color_scale_global",
                               "color_shift_global", "color_transform",
                               "color_scale", "color_shift"],
                },
            },
        },
        "color": {
            "type": "base",
            "net": {
                "type": "tensor_vm_split_time",
                "white_bg": 0,
                "black_bg": 0,
                "fea2denseAct": "relu",
                "distance_scale": 16.0,
                "density_shift": 0.0,
                "aabb": [[-2.0, -2.0, -1.0], [2.0, 2.0, 1.0]],
                "N_voxel_init": 2097152,
                "N_voxel_final": 512000000,
                "upsamp_list": [4000, 6000, 8000, 10000, 12000],
                "lr_upsample_reset": True,
                "update_AlphaMask_list": [4000, 8000],
                "rm_weight_mask_thre": 0,
                "alpha_mask_thre": 1e-3,
                "n_lamb_sigma": [8, 0, 0],
                "n_lamb_sh": [8, 0, 0],
                "shadingMode": "SH",
                "data_dim_color": 27,
                "densityMode": "Density",
                # fused eval path (models/fused_eval.py)
                "fused_render": True,
            },
        },
    }


def llff_z_plane(z_channels=32):
    """Static HyperReel model with mipnerf-contracted z-planes (reference
    conf/experiment/model/llff_z_plane.yaml)."""
    return {
        "type": "lightfield",
        "param": {"n_dims": 6, "fn": "identity"},
        "embedding": {
            "type": "ray_point",
            "embeddings": {
                "ray_prediction_0": {
                    "type": "ray_prediction",
                    "params": {
                        "ray": {
                            "start": 0, "end": 6,
                            "param": {"n_dims": 6, "fn": "pluecker",
                                      "direction_multiplier": 1.0,
                                      "moment_multiplier": 1.0},
                            "pe": {"type": "windowed", "n_freqs": 1,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                    },
                    "net": {"type": "base", "group": "embedding_impl",
                            "depth": 6, "hidden_channels": 256, "skips": [3]},
                    "z_channels": z_channels,
                    "outputs": {
                        "z_vals": {"channels": 1},
                        "sigma": {"channels": 1,
                                  "activation": _ease_sigmoid(3, 0)},
                        "point_sigma": {"channels": 1,
                                        "activation": _ease_sigmoid(3, 1)},
                        "point_offset": {
                            "channels": 3,
                            "activation": {"type": "tanh",
                                           "outer_fac": 0.125},
                        },
                        "color_scale": {"channels": 3,
                                        "activation": _ease_zero()},
                        "color_shift": {"channels": 3,
                                        "activation": _ease_zero()},
                    },
                },
                "ray_intersect_0": {
                    "type": "ray_intersect",
                    "z_channels": z_channels,
                    "intersect": {
                        "type": "z_plane",
                        "sort": True,
                        "use_disparity": False,
                        "use_sigma": True,
                        "out_points": "raw_points",
                        "out_distance": "raw_distance",
                        "initial": -1.0,
                        "end": 1.0,
                        "contract": {
                            "type": "mipnerf",
                            "contract_samples": True,
                            "contract_start_radius": 1.0,
                            "contract_end_radius": 8.0,
                        },
                        "activation": {"type": "identity", "fac": 0.5},
                    },
                },
                "point_offset_0": {
                    "type": "point_offset",
                    "in_density_field": "point_sigma",
                    "use_sigma": True,
                },
                "add_point_outputs_0": {
                    "type": "add_point_outputs",
                    "extra_outputs": ["viewdirs"],
                },
                "extract_fields": {
                    "type": "extract_fields",
                    "fields": ["points", "distances", "viewdirs", "weights",
                               "color_scale", "color_shift"],
                },
            },
        },
        "color": {
            "type": "base",
            "net": {
                "type": "tensor_vm_split_no_sample",
                # fused eval when eligible (models/fused_eval.py)
                "fused_render": True,
                "white_bg": 0,
                "black_bg": 0,
                "fea2denseAct": "relu",
                "distance_scale": 16.0,
                "density_shift": 0.0,
                "aabb": [[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]],
                "N_voxel_init": 2097152,
                "N_voxel_final": 262144000,
                "upsamp_list": [4000, 6000, 8000, 10000, 12000],
                "lr_upsample_reset": True,
                "update_AlphaMask_list": [],
                "rm_weight_mask_thre": 0,
                "alpha_mask_thre": 1e-3,
                "n_lamb_sigma": [8, 4, 4],
                "n_lamb_sh": [8, 4, 4],
                "shadingMode": "SH",
                "data_dim_color": 27,
            },
        },
    }


def neural_3d_z_plane(z_channels=64):
    """Dynamic HyperReel model for the Neural 3D Video scenes (reference
    conf/experiment/model/neural_3d_z_plane.yaml): pluecker rays with a
    1-frequency PE, 64 z-planes with the mipnerf contraction, spatial flow
    (outer_fac 4), a soft sigma gate (sigmoid shift 1), and [8, 4, 4]
    keyframe grids on all three axes."""
    cfg = technicolor_z_plane(z_channels=z_channels)
    pred = cfg["embedding"]["embeddings"]["ray_prediction_0"]
    pred["params"]["ray"] = {
        "start": 0, "end": 6,
        "param": {"n_dims": 6, "fn": "pluecker",
                  "direction_multiplier": 1.0, "moment_multiplier": 1.0},
        "pe": {"type": "windowed", "n_freqs": 1, "freq_multiplier": 2.0,
               "wait_iters": 0, "max_freq_epoch": 0},
    }
    pred["outputs"]["spatial_flow"]["activation"]["outer_fac"] = 4.0
    pred["outputs"]["sigma"]["activation"] = _ease_sigmoid(3, 0, shift=1.0)
    isect = cfg["embedding"]["embeddings"]["ray_intersect_0"]["intersect"]
    isect["outward_facing"] = False
    isect["contract"] = {
        "type": "mipnerf",
        "contract_samples": True,
        "contract_start_radius": 1.0,
        "contract_end_radius": 8.0,
    }
    net = cfg["color"]["net"]
    net.update({
        "aabb": [[-2.0, -1.5, -1.25], [2.0, 1.5, 1.25]],
        "N_voxel_final": 262144000,
        "update_AlphaMask_list": [],
        "n_lamb_sigma": [8, 4, 4],
        "n_lamb_sh": [8, 4, 4],
    })
    return cfg


def stanford_llff_z_plane(z_channels=32):
    """Stanford light fields, two-plane NDC parameterization + z-planes
    (reference conf/experiment/model/stanford_llff_z_plane.yaml): one
    plane x line axis ([8, 0, 0]) with RGB colour."""
    return {
        "type": "lightfield",
        "param": {"n_dims": 6, "fn": "identity"},
        "embedding": {
            "type": "ray_point",
            "embeddings": {
                "ray_prediction_0": {
                    "type": "ray_prediction",
                    "params": {
                        "ray": {
                            "start": 0, "end": 6,
                            "param": {"n_dims": 4, "fn": "two_plane",
                                      "near": -1.0, "far": 0.0},
                            "pe": {"type": "windowed", "n_freqs": 1,
                                   "freq_multiplier": 2.0,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                    },
                    "net": {"type": "base", "group": "embedding_impl",
                            "depth": 6, "hidden_channels": 256, "skips": [3]},
                    "z_channels": z_channels,
                    "outputs": {
                        "z_vals": {"channels": 1},
                        "sigma": {"channels": 1,
                                  "activation": _ease_sigmoid(0, 0)},
                        "point_sigma": {"channels": 1,
                                        "activation": _ease_sigmoid(0, 0)},
                        "point_offset": {
                            "channels": 3,
                            "activation": {"type": "tanh",
                                           "outer_fac": 0.25},
                        },
                        "color_scale": {"channels": 3,
                                        "activation": _ease_zero()},
                        "color_shift": {"channels": 3,
                                        "activation": _ease_zero()},
                    },
                },
                "ray_intersect_0": {
                    "type": "ray_intersect",
                    "z_channels": z_channels,
                    "intersect": {
                        "type": "z_plane",
                        "sort": True,
                        "outward_facing": False,
                        "use_disparity": False,
                        "use_sigma": True,
                        "out_points": "raw_points",
                        "out_distance": "raw_distance",
                        "initial": -1.0,
                        "end": 1.0,
                        "mask": {"stop_iters": -1},
                        "activation": {"type": "identity", "fac": 0.5},
                    },
                },
                "point_offset_0": {
                    "type": "point_offset",
                    "in_density_field": "point_sigma",
                    "use_sigma": True,
                },
                "add_point_outputs_0": {
                    "type": "add_point_outputs",
                    "extra_outputs": ["viewdirs"],
                },
                "extract_fields": {
                    "type": "extract_fields",
                    "fields": ["points", "distances", "viewdirs", "weights",
                               "color_scale", "color_shift"],
                },
            },
        },
        "color": {
            "type": "base",
            "net": {
                "type": "tensor_vm_split_no_sample",
                "white_bg": 0,
                "black_bg": 0,
                "fea2denseAct": "relu",
                "distance_scale": 8.0,
                "density_shift": 0.0,
                "aabb": [[-2.0, -2.0, -1.0], [2.0, 2.0, 1.0]],
                "N_voxel_init": 512000,
                "N_voxel_final": 512000000,
                "upsamp_list": [4000, 6000, 8000, 10000, 12000],
                "lr_upsample_reset": True,
                "update_AlphaMask_list": [4000, 8000],
                "rm_weight_mask_thre": 0,
                "alpha_mask_thre": 1e-3,
                "n_lamb_sigma": [8, 0, 0],
                "n_lamb_sh": [8, 0, 0],
                "shadingMode": "RGB",
                "data_dim_color": 3,
                # the net's own fused route (TensorVMNoSample.apply_fused)
                "fused_render": True,
            },
        },
    }


def shiny_z_plane(z_channels=32, sample_stages=False):
    """Shiny dense scenes, two-plane rays + z-planes (reference
    conf/experiment/model/shiny_z_plane.yaml): stanford_llff_z_plane's
    chain with ease windows on the sigmas, no near/far mask,
    num_samples_for_scale 32, and [8, 4, 4] components (the llff layout)
    with RGB colour. The reference's generate_samples / select_points
    stages are commented out upstream (shiny_z_plane.yaml:150-159);
    `sample_stages=True` puts them after the intersect (a count drawn in
    [z_channels // 2, z_channels] per training step, all z_channels at
    eval), as the JAX package's shiny_z_plane does."""
    cfg = stanford_llff_z_plane(z_channels=z_channels)
    emb = cfg["embedding"]["embeddings"]
    pred = emb["ray_prediction_0"]
    pred["params"]["ray"]["param"] = {"n_dims": 4, "fn": "two_plane"}
    pred["outputs"]["sigma"]["activation"] = _ease_sigmoid(3, 0)
    pred["outputs"]["point_sigma"]["activation"] = _ease_sigmoid(3, 1)
    isect = emb["ray_intersect_0"]["intersect"]
    del isect["mask"]
    isect["num_samples_for_scale"] = 32
    cfg["color"]["net"].update(N_voxel_init=2097152, N_voxel_final=262144000,
                               n_lamb_sigma=[8, 4, 4], n_lamb_sh=[8, 4, 4])
    if sample_stages:
        out = {}
        for name in emb:
            out[name] = emb[name]
            if name == "ray_intersect_0":
                out["generate_samples_0"] = {
                    "type": "generate_samples",
                    "sample_range": [z_channels // 2, z_channels],
                    "inference_samples": z_channels,
                    "total_samples": z_channels,
                }
                out["select_points_0"] = {
                    "type": "select_points",
                    "fields": ["points", "distances", "sigma", "point_sigma",
                               "point_offset", "weights", "color_scale",
                               "color_shift"],
                }
        cfg["embedding"]["embeddings"] = out
    return cfg



def donerf_sphere(z_channels=32):
    """Static HyperReel with concentric-sphere primitives + dataset-bound
    mipnerf contraction (reference conf/experiment/model/donerf_sphere.yaml;
    BASELINE.md pipeline #2). The reference predicts 4 z-channels per sample
    (origin scale + radius) but ships origin_scale_factor=0.0, which makes
    the origin channels inert — we predict the radius channel only."""
    return {
        "type": "lightfield",
        "param": {"n_dims": 6, "fn": "identity"},
        "embedding": {
            "type": "ray_point",
            "embeddings": {
                "ray_prediction_0": {
                    "type": "ray_prediction",
                    "params": {
                        "ray": {
                            "start": 0, "end": 6,
                            "param": {"n_dims": 6, "fn": "pluecker",
                                      "direction_multiplier": 1.0,
                                      "moment_multiplier": 1.0},
                            "pe": {"type": "windowed", "n_freqs": 1,
                                   "freq_multiplier": 2.0,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                    },
                    "net": {"type": "base", "group": "embedding_impl",
                            "depth": 6, "hidden_channels": 256, "skips": [3]},
                    "z_channels": z_channels,
                    "outputs": {
                        "z_vals": {"channels": 1},
                        "sigma": {"channels": 1,
                                  "activation": _ease_sigmoid(3, 0)},
                        "point_sigma": {"channels": 1,
                                        "activation": _ease_sigmoid(3, 1)},
                        "point_offset": {
                            "channels": 3,
                            "activation": {"type": "tanh",
                                           "outer_fac": 0.125},
                        },
                        "color_scale": {"channels": 3,
                                        "activation": _ease_zero()},
                        "color_shift": {"channels": 3,
                                        "activation": _ease_zero()},
                    },
                },
                "ray_intersect_0": {
                    "type": "ray_intersect",
                    "z_channels": z_channels,
                    "intersect": {
                        "type": "sphere",
                        "sort": True,
                        "outward_facing": False,
                        "use_disparity": False,
                        "max_axis": False,
                        "use_sigma": True,
                        "out_points": "raw_points",
                        "out_distance": "raw_distance",
                        "use_dataset_bounds": True,
                        "origin_scale_factor": 0.0,
                        "contract": {
                            "type": "mipnerf",
                            "contract_samples": True,
                            "use_dataset_bounds": True,
                        },
                        "activation": {"type": "identity", "fac": 0.5},
                    },
                },
                "point_offset_0": {
                    "type": "point_offset",
                    "use_sigma": True,
                },
                "add_point_outputs_0": {
                    "type": "add_point_outputs",
                    "extra_outputs": ["viewdirs"],
                },
                "extract_fields": {
                    "type": "extract_fields",
                    "fields": ["points", "distances", "viewdirs", "weights",
                               "color_scale", "color_shift"],
                },
            },
        },
        "color": {
            "type": "base",
            "net": {
                "type": "tensor_vm_split_no_sample",
                # fused Pallas eval when eligible (single- or multi-axis static kernel)
                "fused_render": True,
                "white_bg": 0,
                "black_bg": 0,
                "fea2denseAct": "relu",
                "distance_scale": 16.0,
                "density_shift": 0.0,
                "aabb": [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]],
                "N_voxel_init": 3375000,
                "N_voxel_final": 216000000,
                "upsamp_list": [4000, 6000, 8000, 10000, 12000],
                "lr_upsample_reset": True,
                "update_AlphaMask_list": [4000, 8000],
                "rm_weight_mask_thre": 0,
                "alpha_mask_thre": 1e-3,
                "n_lamb_sigma": [8, 4, 4],
                "n_lamb_sh": [8, 4, 4],
                "shadingMode": "RGB",
                "data_dim_color": 3,
            },
        },
    }


def donerf_cylinder(z_channels=32):
    """donerf_sphere with concentric CYLINDER primitives — the reference
    configs differ only in the intersect type (diff of
    conf/experiment/model/donerf_sphere.yaml vs donerf_cylinder.yaml:
    `type: sphere` -> `type: cylinder`)."""
    cfg = donerf_sphere(z_channels=z_channels)
    cfg["embedding"]["embeddings"]["ray_intersect_0"]["intersect"][
        "type"] = "cylinder"
    return cfg


def catacaustics_distance(z_channels=64):
    """Static HyperReel with DIRECT per-sample distance prediction
    (euclidean_distance_unified) + mipnerf contraction on Catacaustics
    captures (reference conf/experiment/model/catacaustics_distance.yaml).
    The reference writes the grid schedule as grid_size start/end
    [100^3 -> 400^3]; with its cubic aabb that is exactly
    N_voxel_init/final 1e6 -> 6.4e7 through n_to_reso, which is the form
    used here."""
    cfg = donerf_sphere(z_channels=z_channels)
    emb = cfg["embedding"]["embeddings"]
    pred = emb["ray_prediction_0"]
    pred["params"]["ray"]["pe"] = {
        "type": "windowed", "n_freqs": 2, "freq_multiplier": 2.0,
        "wait_iters": 0, "max_freq_epoch": 0}
    outs = pred["outputs"]
    outs.pop("color_scale", None)
    outs.pop("color_shift", None)
    outs.pop("point_sigma", None)
    outs["point_offset"] = {"channels": 3,
                            "activation": {"type": "tanh",
                                           "outer_fac": 0.25}}
    outs["color_scale_global"] = {"channels": 3, "activation": _ease_zero()}
    outs["color_shift_global"] = {"channels": 3, "activation": _ease_zero()}
    emb["ray_intersect_0"]["intersect"] = {
        "type": "euclidean_distance_unified",
        "sort": True,
        "outward_facing": False,
        "use_disparity": False,
        "use_sigma": True,
        "out_points": "raw_points",
        "out_distance": "raw_distance",
        "use_dataset_bounds": True,
        "contract": {"type": "mipnerf", "contract_samples": True,
                     "use_dataset_bounds": True},
        "activation": {"type": "identity", "fac": 0.5},
    }
    emb["point_offset_0"] = {"type": "point_offset", "use_sigma": True}
    emb["extract_fields"]["fields"] = [
        "points", "distances", "viewdirs", "weights",
        "color_scale_global", "color_shift_global"]
    net = cfg["color"]["net"]
    net["N_voxel_init"] = 1000000
    net["N_voxel_final"] = 64000000
    net["n_lamb_sigma"] = [8, 8, 8]
    net["n_lamb_sh"] = [8, 8, 8]
    net["shadingMode"] = "SH"
    net["data_dim_color"] = 27
    return cfg


def immersive_sphere_new(z_channels=32):
    """Dynamic HyperReel for Google Immersive scenes: outward-facing
    concentric spheres with miss fallback (sphere_new), mipnerf
    contraction to dataset bounds, spatial-flow advection, and 3-axis
    [8, 4, 4] keyframe grids (reference
    conf/experiment/model/immersive_sphere_new.yaml; BASELINE.md pipeline
    #5). Deviation as in donerf_sphere: the reference's multi-channel
    z_vals (8 per slot) reduce to per-slot radius offsets — its shipped
    z_scale/origin factors make the extra channels inert."""
    return {
        "type": "lightfield",
        "param": {"n_dims": 6, "fn": "identity"},
        "embedding": {
            "type": "ray_point",
            "embeddings": {
                "ray_prediction_0": {
                    "type": "ray_prediction",
                    "params": {
                        "ray": {
                            "start": 0, "end": 6,
                            "param": {"n_dims": 6, "fn": "pluecker",
                                      "direction_multiplier": 1.0,
                                      "moment_multiplier": 1.0},
                            "pe": {"type": "windowed", "n_freqs": 1,
                                   "freq_multiplier": 2.0,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                        "time": {
                            "start": 7, "end": 8,
                            "param": {"n_dims": 1, "fn": "identity"},
                            "pe": {"type": "windowed", "n_freqs": 2,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                    },
                    "net": {"type": "base", "group": "embedding_impl",
                            "depth": 6, "hidden_channels": 256, "skips": [3]},
                    "z_channels": z_channels,
                    "outputs": {
                        "z_vals": {"channels": 1},
                        "spatial_flow": {
                            "channels": 3,
                            "activation": {"type": "identity",
                                           "outer_fac": 1.0},
                        },
                        "sigma": {"channels": 1,
                                  "activation": _ease_sigmoid(3, 0)},
                        "point_sigma": {"channels": 1,
                                        "activation": _ease_sigmoid(3, 1)},
                        "point_offset": {
                            "channels": 3,
                            "activation": {"type": "tanh", "outer_fac": 0.25},
                        },
                        "color_scale": {"channels": 3,
                                        "activation": _ease_zero()},
                        "color_shift": {"channels": 3,
                                        "activation": _ease_zero()},
                    },
                },
                "ray_intersect_0": {
                    "type": "ray_intersect",
                    "z_channels": z_channels,
                    "intersect": {
                        "type": "sphere_new",
                        "sort": True,
                        "outward_facing": True,
                        "use_disparity": False,
                        "max_axis": False,
                        "use_sigma": True,
                        "out_points": "raw_points",
                        "out_distance": "raw_distance",
                        "use_dataset_bounds": True,
                        "resize_scale_factor": 1.0,
                        "origin_scale_factor": 1.0,
                        "contract": {
                            "type": "mipnerf",
                            "contract_samples": True,
                            "use_dataset_bounds": True,
                        },
                        "activation": {"type": "identity", "fac": 0.5},
                    },
                },
                "flow_0": {
                    "type": "advect_points",
                    "use_spatial_flow": True,
                    "use_angular_flow": False,
                    "out_flow_field": "raw_flow",
                    "flow_scale": 0.0,
                    "spatial_flow_activation": {"type": "identity",
                                                "fac": 0.25},
                },
                "point_offset_0": {
                    "type": "point_offset",
                    "in_density_field": "point_sigma",
                    "use_sigma": True,
                },
                "add_point_outputs_0": {
                    "type": "add_point_outputs",
                    "extra_outputs": ["viewdirs", "times"],
                },
                "extract_fields": {
                    "type": "extract_fields",
                    "fields": ["points", "distances", "base_times",
                               "time_offset", "times", "viewdirs", "weights",
                               "color_transform_global", "color_scale_global",
                               "color_shift_global", "color_transform",
                               "color_scale", "color_shift"],
                },
            },
        },
        "color": {
            "type": "base",
            "net": {
                "type": "tensor_vm_split_time",
                # fused Pallas eval when eligible
                "fused_render": True,
                "white_bg": 0,
                "black_bg": 0,
                "fea2denseAct": "relu",
                "distance_scale": 16.0,
                "density_shift": 0.0,
                "aabb": [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]],
                "N_voxel_init": 2097152,
                "N_voxel_final": 262144000,
                "upsamp_list": [4000, 6000, 8000, 10000, 12000],
                "lr_upsample_reset": True,
                "update_AlphaMask_list": [4000, 8000],
                "rm_weight_mask_thre": 0,
                "alpha_mask_thre": 1e-3,
                "n_lamb_sigma": [8, 4, 4],
                "n_lamb_sh": [8, 4, 4],
                "shadingMode": "SH",
                "data_dim_color": 27,
                "densityMode": "Density",
            },
        },
    }

def blender_voxel(z_channels=192):
    """Static HyperReel with axis-aligned voxel-grid primitives on
    synthetic Blender scenes (reference
    conf/experiment/model/blender_voxel.yaml): pluecker rays with a
    windowed 2-freq PE, 192 z-channels over 3 axes, pre-intersect ray
    density (sigmoid, shift 2), voxel_grid intersection over [-2, 2]^3
    with [2, 6] clipping, post-intersect point density + offsets, and a
    [8, 8, 8] softplus TensorVM color net on a white background."""
    density = {"type": "point_density", "shift": 2.0,
               "activation": {"type": "sigmoid", "fac": 1.0}}
    return {
        "type": "lightfield",
        "param": {"n_dims": 6, "fn": "identity"},
        "embedding": {
            "type": "ray_point",
            "embeddings": {
                "ray_prediction_0": {
                    "type": "ray_prediction",
                    "params": {
                        "ray": {
                            "start": 0, "end": 6,
                            "param": {"n_dims": 6, "fn": "pluecker",
                                      "direction_multiplier": 1.0,
                                      "moment_multiplier": 1.0},
                            "pe": {"type": "windowed", "n_freqs": 2,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                    },
                    "net": {"type": "base", "group": "embedding_impl",
                            "depth": 6, "hidden_channels": 256,
                            "skips": [3]},
                    "z_channels": z_channels,
                    "outputs": {
                        "z_vals": {"channels": 1},
                        "sigma": {"channels": 1},
                        "point_offset": {"channels": 3},
                    },
                },
                "point_density_0": dict(density),
                "ray_intersect_0": {
                    "type": "ray_intersect",
                    "z_channels": z_channels,
                    "intersect": {
                        "type": "voxel_grid",
                        "sort": True,
                        "outward_facing": False,
                        "use_disparity": False,
                        "use_sigma": True,
                        "origin": [0.0, 0.0, 0.0],
                        "initial": [-2.0, -2.0, -2.0],
                        "end": [2.0, 2.0, 2.0],
                        "near": 2.0,
                        "far": 6.0,
                        "activation": {"type": "identity", "fac": 0.5},
                    },
                },
                "add_point_outputs_0": {
                    "type": "add_point_outputs",
                    "extra_outputs": ["viewdirs"],
                },
                "point_density_1": dict(density),
                "point_offset_0": {
                    "type": "point_offset",
                    "use_sigma": True,
                    "activation": {"type": "identity", "fac": 0.25},
                },
                "extract_fields": {
                    "type": "extract_fields",
                    "fields": ["points", "distances", "viewdirs"],
                },
            },
        },
        "color": {
            "type": "base",
            "net": {
                "type": "tensor_vm_split_no_sample",
                # fused Pallas eval when eligible (single- or multi-axis static kernel)
                "fused_render": True,
                "white_bg": 1,
                "ndc_ray": 0,
                "fea2denseAct": "softplus",
                "distance_scale": 25.0,
                "density_shift": -10.0,
                "aabb": [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]],
                "N_voxel_init": 1000000,
                "N_voxel_final": 27000000,
                "upsamp_list": [4000, 6000, 8000, 10000, 12000],
                "lr_upsample_reset": True,
                "update_AlphaMask_list": [4000, 8000],
                "rm_weight_mask_thre": 1e-4,
                "alpha_mask_thre": 1e-4,
                "n_lamb_sigma": [8, 8, 8],
                "n_lamb_sh": [8, 8, 8],
                "shadingMode": "SH",
                "data_dim_color": 27,
            },
        },
    }



def technicolor_cascaded(coarse_z=8, z_channels=32):
    """Two-stage cascaded sample prediction (reference
    conf/experiment/model/technicolor_cascaded.yaml): a coarse
    ray-prediction MLP places 8 z-planes, their intersection points feed a
    per-point refinement MLP (point_prediction) that emits the full
    32-sample set plus flow/offset/calibration fields, followed by a
    second z-plane intersect."""
    return {
        "type": "lightfield",
        "param": {"n_dims": 6, "fn": "identity"},
        "embedding": {
            "type": "ray_point",
            "embeddings": {
                "ray_prediction_0": {
                    "type": "ray_prediction",
                    "params": {
                        "ray": {
                            "start": 0, "end": 6,
                            "param": {"n_dims": 4, "fn": "two_plane"},
                            "pe": {"type": "windowed", "n_freqs": 0,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                        "time": {
                            "start": 7, "end": 8,
                            "param": {"n_dims": 1, "fn": "identity"},
                            "pe": {"type": "windowed", "n_freqs": 2,
                                   "wait_iters": 0, "max_freq_epoch": 0},
                        },
                    },
                    "net": {"type": "base", "group": "embedding_impl",
                            "depth": 6, "hidden_channels": 256, "skips": [3]},
                    "z_channels": coarse_z,
                    "outputs": {"z_vals": {"channels": 1}},
                },
                "ray_intersect_0": {
                    "type": "ray_intersect",
                    "z_channels": coarse_z,
                    "intersect": {
                        "type": "z_plane",
                        "sort": True,
                        "use_disparity": False,
                        "use_sigma": True,
                        "out_points": "raw_points",
                        "out_distance": "raw_distance",
                        "initial": -1.0,
                        "end": 1.0,
                        "activation": {"type": "identity", "fac": 0.5},
                    },
                },
                "point_prediction_0": {
                    "type": "point_prediction",
                    "in_z_channels": coarse_z,
                    "inputs": {"points": 3, "viewdirs": 3, "times": 1},
                    # ranges index the CONCATENATED inputs above;
                    # `time: 3:4` therefore reads viewdirs.x — the
                    # shipped technicolor_cascaded.yaml's exact ranges
                    # (reference point.py:120-127 quirk, kept faithfully)
                    "params": {
                        "ray": {
                            "start": 0, "end": 3,
                            "param": {"n_dims": 3, "fn": "identity"},
                            "pe": {"type": "basic", "n_freqs": 2},
                        },
                        "time": {
                            "start": 3, "end": 4,
                            "param": {"n_dims": 1, "fn": "identity"},
                            "pe": {"type": "basic", "n_freqs": 4},
                        },
                    },
                    "net": {"type": "base", "group": "embedding_impl",
                            "depth": 6, "hidden_channels": 256, "skips": [3]},
                    "out_z_channels": z_channels,
                    "outputs": {
                        "z_vals": {"channels": 1},
                        "spatial_flow": {"channels": 3},
                        "sigma": {"channels": 1,
                                  "activation": _ease_sigmoid(3, 0)},
                        "point_sigma": {"channels": 1,
                                        "activation": _ease_sigmoid(3, 1)},
                        "point_offset": {
                            "channels": 3,
                            "activation": {"type": "tanh",
                                           "outer_fac": 0.125},
                        },
                        "color_scale": {"channels": 3,
                                        "activation": _ease_zero()},
                        "color_shift": {"channels": 3,
                                        "activation": _ease_zero()},
                    },
                },
                "ray_intersect_1": {
                    "type": "ray_intersect",
                    "z_channels": z_channels,
                    "intersect": {
                        "type": "z_plane",
                        "sort": True,
                        "use_disparity": False,
                        "use_sigma": True,
                        "initial": -1.0,
                        "end": 1.0,
                        "activation": {"type": "identity", "fac": 0.5},
                    },
                },
                "flow_0": {
                    "type": "advect_points",
                    "use_spatial_flow": True,
                    "use_angular_flow": False,
                    "out_flow_field": "raw_flow",
                    "flow_scale": 0.0,
                    "spatial_flow_activation": {"type": "identity",
                                                "fac": 0.25},
                },
                "point_offset_1": {
                    "type": "point_offset",
                    "in_density_field": "point_sigma",
                    "use_sigma": True,
                },
                "add_point_outputs_0": {
                    "type": "add_point_outputs",
                    "extra_outputs": ["viewdirs", "times"],
                },
                "extract_fields": {
                    "type": "extract_fields",
                    "fields": ["points", "distances", "base_times",
                               "time_offset", "times", "viewdirs", "weights",
                               "color_transform_global", "color_scale_global",
                               "color_shift_global", "color_transform",
                               "color_scale", "color_shift"],
                },
            },
        },
        "color": technicolor_z_plane()["color"],
    }



def shiny_z_deformable(z_channels=64):
    """Shiny with DEFORMABLE plane primitives: each sample predicts a
    plane-normal perturbation + offset (4 z channels/sample) intersected
    as learned-normal planes from start_normal [0, 0, 1]
    (reference conf/experiment/model/shiny_z_deformable.yaml)."""
    cfg = shiny_z_plane(z_channels=z_channels)
    emb = cfg["embedding"]["embeddings"]
    pred = emb["ray_prediction_0"]
    pred["params"]["ray"]["pe"] = {"type": "basic", "n_freqs": 2}
    pred["outputs"] = {
        "z_vals": {"channels": 4},
        "sigma": {"channels": 1,
                  "activation": {"type": "sigmoid", "fac": 1.0,
                                 "shift": 4.0}},
        "point_offset": {"channels": 3,
                         "activation": {"type": "tanh", "fac": 0.25}},
    }
    emb["ray_intersect_0"]["intersect"] = {
        "type": "deformable_voxel_grid",
        "sort": True,
        "outward_facing": False,
        "use_disparity": False,
        "use_sigma": False,
        "max_axis": False,
        "out_points": "raw_points",
        "out_distance": "raw_distance",
        "start_normal": [[0.0, 0.0, 1.0]],
        "normal_scale_factor": 1.0,
        "initial": [-1.0],
        "end": [1.0],
        "activation": {"type": "identity", "fac": 0.5},
    }
    emb["point_offset_0"] = {"type": "point_offset", "use_sigma": True}
    emb["extract_fields"]["fields"] = ["points", "distances", "viewdirs",
                                       "weights"]
    return cfg


def refnerf_sphere(z_channels=64, reflect=False):
    """RefNeRF-style sphere model (reference
    conf/experiment/model/refnerf_sphere.yaml). The shipped yaml has its
    reflect_0 stage commented out; `reflect=True` enables the full
    RefNeRF composition the yaml sketches (normal / ref_distance /
    ref_viewdirs_offset MLP outputs + the reflect embedding reflecting
    viewdirs, reference nlf/embedding/point.py:673-738)."""
    cfg = donerf_sphere(z_channels=z_channels)
    emb = cfg["embedding"]["embeddings"]
    pred = emb["ray_prediction_0"]
    pred["params"]["ray"]["pe"]["n_freqs"] = 1
    pred["outputs"]["point_offset"]["activation"]["outer_fac"] = 0.125
    isect = emb["ray_intersect_0"]["intersect"]
    isect["initial"] = -2.0
    isect["end"] = 2.0
    isect["resize_scale_factor"] = 0.0
    isect.pop("contract", None)
    net = cfg["color"]["net"]
    net["white_bg"] = 1
    net["distance_scale"] = 8.0
    net["aabb"] = [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]]
    net["update_AlphaMask_list"] = []
    if reflect:
        pred["outputs"]["normal"] = {
            "channels": 3, "activation": {"type": "identity"}}
        pred["outputs"]["ref_distance"] = {
            "channels": 1, "activation": {"type": "identity"}}
        # the yaml's commented reflect_0 block: reflect about the
        # direction-initialized normal and override viewdirs
        new_emb = {}
        for key, val in emb.items():
            new_emb[key] = val
            if key == "ray_intersect_0":
                new_emb["reflect_0"] = {
                    "type": "reflect",
                    "direction_init": True,
                    "out_points_field": "points_temp",
                    "out_direction_field": "viewdirs",
                }
        cfg["embedding"]["embeddings"] = new_emb
    return cfg


def refnerf_sphere_reflect(z_channels=64):
    return refnerf_sphere(z_channels=z_channels, reflect=True)



def with_coherent_gather(cfg, px=4, py=3, block=4):
    """Enable the coherent patch-gather render path (one (px x py)-texel
    row per `block`-consecutive-ray block and sample slot —
    ops/patch_gather.py). EXACT only for scanline-coherent frame renders
    whose block footprints fit the patch (high pixel density);
    out-of-patch corners degrade to the zero-padding value. The coverage
    witness (outputs["patch_coverage_viol"]) reports violations per
    call. block=8 needs a wider patch (e.g. px=5) at scanline pixel
    order. Eval-only: training and the general path ignore the flag.
    Returns a new config."""
    cfg = copy.deepcopy(cfg)
    cfg["color"]["net"]["coherent_gather"] = [int(px), int(py),
                                              int(block)]
    return cfg


def with_compact_samples(cfg, n, always=False):
    """Render-time sample compaction: the intersect sorts invalid samples
    to the far end (`invalid_sort_far`: a far sentinel distance), and a
    select_points stage right after it keeps the first n sorted samples,
    the n nearest valid ones, so that every per-sample cost after it
    scales with n instead of z_channels. `always=True` also slices in
    training. Returns a new config."""
    cfg = copy.deepcopy(cfg)
    emb = cfg["embedding"]["embeddings"]
    out = {}
    for name in emb:
        out[name] = emb[name]
        if emb[name].get("type") == "ray_intersect":
            emb[name]["intersect"]["invalid_sort_far"] = True
            out["select_points_compact"] = {
                "type": "select_points",
                "mode": "first",
                "inference_samples": int(n),
                "always_slice": bool(always),
            }
    cfg["embedding"]["embeddings"] = out
    return cfg


def with_inference_samples(cfg, n):
    """Insert a select_points stage (the reference's inference-time sample
    count, nlf/embedding/point.py:402-480) right before the chain's
    add_point_outputs / extract_fields stage: at eval every per-sample
    field keeps every (z_channels // n)-th sample; training is unchanged.
    Returns a new config."""
    cfg = copy.deepcopy(cfg)
    emb = cfg["embedding"]["embeddings"]
    out = {}
    inserted = False
    names = list(emb.keys())
    for i, name in enumerate(names):
        out[name] = emb[name]
        nxt = names[i + 1] if i + 1 < len(names) else None
        if not inserted and (
                nxt is None
                or emb.get(nxt, {}).get("type") in (
                    "add_point_outputs", "extract_fields")):
            out["select_points_inference"] = {
                "type": "select_points",
                "inference_samples": int(n),
            }
            inserted = True
    cfg["embedding"]["embeddings"] = out
    return cfg


def tiny_static(z_channels=8, grid=32):
    """Miniature static config for tests/smoke training (no reference
    analog; shapes chosen for fast CPU jit). bf16 gather tables are off so
    numeric tests stay deterministic at f32."""
    cfg = llff_z_plane(z_channels=z_channels)
    net = cfg["color"]["net"]
    net["bf16_tables"] = False
    net["N_voxel_init"] = grid ** 3
    net["N_voxel_final"] = grid ** 3
    net["upsamp_list"] = []
    net["n_lamb_sigma"] = [4, 2, 2]
    net["n_lamb_sh"] = [4, 2, 2]
    cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"].update(
        {"depth": 4, "hidden_channels": 64, "skips": [2]})
    return cfg


def _shrink_for_tests(cfg, grid=32):
    net = cfg["color"]["net"]
    net["bf16_tables"] = False
    net["N_voxel_init"] = grid ** 3
    net["N_voxel_final"] = grid ** 3
    net["upsamp_list"] = []
    net["update_AlphaMask_list"] = []
    n_ax = [1 if c else 0 for c in net["n_lamb_sigma"]]
    net["n_lamb_sigma"] = [4 * c for c in n_ax]
    net["n_lamb_sh"] = [4 * c for c in n_ax]
    cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"].update(
        {"depth": 4, "hidden_channels": 64, "skips": [2]})
    return cfg


def tiny_neural_3d(z_channels=8, grid=32):
    """Miniature neural_3d_z_plane for tests."""
    return _shrink_for_tests(neural_3d_z_plane(z_channels=z_channels), grid)


def tiny_dynamic(z_channels=8, grid=32):
    """Miniature dynamic config for tests."""
    cfg = technicolor_z_plane(z_channels=z_channels)
    net = cfg["color"]["net"]
    net["bf16_tables"] = False
    net["N_voxel_init"] = grid ** 3
    net["N_voxel_final"] = grid ** 3
    net["upsamp_list"] = []
    net["update_AlphaMask_list"] = []
    net["n_lamb_sigma"] = [4, 0, 0]
    net["n_lamb_sh"] = [4, 0, 0]
    cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"].update(
        {"depth": 4, "hidden_channels": 64, "skips": [2]})
    return cfg


def _bf16_tables(cfg):
    """The fused routes need bf16 tables (as the JAX package's
    _fused_eligible), which the JAX package's tiny versions turn off."""
    cfg["color"]["net"]["bf16_tables"] = True
    return cfg


def tiny_stanford_llff(z_channels=8, grid=32):
    """Miniature stanford_llff_z_plane for tests, with bf16 tables: the
    net's own fused route needs them (as the JAX package's
    _fused_eligible), where the JAX package's tiny version turns them
    off."""
    return _bf16_tables(_shrink_for_tests(
        stanford_llff_z_plane(z_channels=z_channels), grid))


def tiny_shiny(z_channels=8, grid=32, sample_stages=True):
    """Miniature shiny_z_plane for tests, with the sample stages as the
    JAX package's tiny_shiny (the model then takes the general chain and
    the net's own fused route; `sample_stages=False` gives the
    channels-first route), and with bf16 tables, which the fused routes
    need."""
    return _bf16_tables(_shrink_for_tests(
        shiny_z_plane(z_channels=z_channels, sample_stages=sample_stages),
        grid))


def tiny_donerf_sphere(z_channels=8, grid=32):
    """Miniature donerf_sphere for tests, with bf16 tables."""
    return _bf16_tables(_shrink_for_tests(
        donerf_sphere(z_channels=z_channels), grid))


def tiny_donerf_cylinder(z_channels=8, grid=32):
    """Miniature donerf_cylinder for tests, with bf16 tables."""
    return _bf16_tables(_shrink_for_tests(
        donerf_cylinder(z_channels=z_channels), grid))


def tiny_catacaustics_distance(z_channels=8, grid=32):
    """Miniature catacaustics_distance for tests ([4, 4, 4] components),
    with bf16 tables."""
    return _bf16_tables(_shrink_for_tests(
        catacaustics_distance(z_channels=z_channels), grid))


def tiny_immersive_sphere(z_channels=8, grid=32):
    """Miniature immersive_sphere_new for tests, with bf16 tables."""
    return _bf16_tables(_shrink_for_tests(
        immersive_sphere_new(z_channels=z_channels), grid))


def small_grid_catacaustics(z_channels=64, grid=32):
    """catacaustics_distance on a grid^3 grid with the tiny MLP (depth 4,
    64 wide) but its own [8, 8, 8] components and 64 samples, which
    _shrink_for_tests would turn into [4, 4, 4]: the test size of K5 at
    the [8, 8, 8] layout with the weights row."""
    cfg = catacaustics_distance(z_channels=z_channels)
    net = cfg["color"]["net"]
    net.update(N_voxel_init=grid ** 3, N_voxel_final=grid ** 3,
               upsamp_list=[], update_AlphaMask_list=[])
    cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"].update(
        {"depth": 4, "hidden_channels": 64, "skips": [2]})
    return cfg


def tiny_cascaded(grid=32):
    """Miniature technicolor_cascaded for tests."""
    cfg = technicolor_cascaded(coarse_z=4, z_channels=8)
    net = cfg["color"]["net"]
    net["bf16_tables"] = False
    net["N_voxel_init"] = grid ** 3
    net["N_voxel_final"] = grid ** 3
    net["upsamp_list"] = []
    net["update_AlphaMask_list"] = []
    for key in ("ray_prediction_0", "point_prediction_0"):
        cfg["embedding"]["embeddings"][key]["net"].update(
            {"depth": 4, "hidden_channels": 64, "skips": [2]})
    return cfg


def tiny_blender_voxel(z_channels=12, grid=32):
    """Miniature blender_voxel for tests (z divisible by 3: the voxel
    grid splits channels across the 3 axes)."""
    return _shrink_for_tests(blender_voxel(z_channels=z_channels), grid)


def tiny_shiny_deformable(z_channels=8, grid=32):
    """Miniature shiny_z_deformable for tests, with bf16 tables (the net's
    own fused route needs them)."""
    return _bf16_tables(_shrink_for_tests(
        shiny_z_deformable(z_channels=z_channels), grid))


def tiny_refnerf_reflect(z_channels=8, grid=32):
    """Miniature reflect-enabled refnerf_sphere for tests, with bf16
    tables."""
    return _bf16_tables(_shrink_for_tests(
        refnerf_sphere(z_channels=z_channels, reflect=True), grid))
