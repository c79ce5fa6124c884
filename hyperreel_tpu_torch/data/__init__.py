"""The dataset registry (port of hyperreel_tpu/data/__init__.py; reference
datasets/__init__.py dataset_dict). Each loader's module is imported when
the loader is called, and reads its files with Pillow or cv2 there. A
`device` given to a loader reaches it where its signature takes one (the
synthetic scenes march their rays on it); the loaders that only read files
compute on the host and are not passed it."""

import importlib
import inspect


def _lazy(name):
    def loader(*args, device=None, **kwargs):
        mod, fn = name.rsplit(".", 1)
        load = getattr(importlib.import_module(
            "hyperreel_tpu_torch.data." + mod), fn)
        if device is not None and \
                "device" in inspect.signature(load).parameters:
            kwargs["device"] = device
        return load(*args, **kwargs)

    return loader


dataset_dict = {
    "llff": _lazy("llff.load_llff"),
    "blender": _lazy("blender.load_blender"),
    "donerf": _lazy("donerf.load_donerf"),
    "technicolor": _lazy("technicolor.load_technicolor"),
    "neural_3d": _lazy("neural_3d.load_neural_3d"),
    "immersive": _lazy("immersive.load_immersive"),
    "stanford": _lazy("stanford.load_stanford_lightfield"),
    "shiny": _lazy("shiny.load_shiny"),
    "spaces": _lazy("spaces.load_spaces"),
    "eikonal": _lazy("eikonal.load_eikonal"),
    "stanford_llff": _lazy("variants.load_stanford_llff"),
    "dense_shiny": _lazy("variants.load_dense_shiny"),
    "dense_blender": _lazy("variants.load_dense_blender"),
    "blender_lightfield": _lazy("variants.load_blender_lightfield"),
    "catacaustics": _lazy("catacaustics.load_catacaustics"),
    "video3d_static": _lazy("video3d.load_video3d_static"),
    "video3d_time": _lazy("video3d.load_video3d_time"),
    "video3d_ground_truth": _lazy("video3d.load_video3d_ground_truth"),
    "fourier": _lazy("aux_datasets.fourier_dataset"),
    "random_ray": _lazy("aux_datasets.random_ray_view_dataset"),
    "random_pixel": _lazy("aux_datasets.random_pixel_dataset"),
    "synthetic_blobs": _lazy("synthetic.gaussian_blob_scene"),
    "random": _lazy("synthetic.random_ray_dataset"),
}


def get_dataset(name, *args, **kwargs):
    """The dataset `name` of dataset_dict, loaded with these arguments."""
    return dataset_dict[name](*args, **kwargs)
