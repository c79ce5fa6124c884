"""Image files for the loaders: Pillow's decode and resize, as the JAX
package's loaders do inline. Pillow is imported where a file is read, so
importing the port needs it nowhere else."""

import numpy as np


def read_rgb(path, wh=None, alpha=False, resize_first=False):
    """The image at `path` as float32 [H, W, 3] in [0, 1] (`alpha`: [H, W,
    4]), resized with LANCZOS to `wh` = (W, H) where its size differs.
    By default it is converted to RGB (RGBA) first; `resize_first`
    resizes in the file's own mode and converts after (blender's and
    donerf's order: Pillow premultiplies an alpha channel while it
    resamples, so the two orders give other pixels)."""
    from PIL import Image

    mode = "RGBA" if alpha else "RGB"
    with Image.open(path) as img:
        if not resize_first:
            img = img.convert(mode)
        if wh is not None and img.size != tuple(wh):
            img = img.resize(tuple(wh), Image.LANCZOS)
        if resize_first:
            img = img.convert(mode)
        return np.asarray(img, np.float32) / 255.0


def image_size(path):
    """(W, H) of the image at `path`, from its header."""
    from PIL import Image

    with Image.open(path) as img:
        return img.size


def resize_nearest(arr, wh):
    """A float32 [H, W] map (a depth image) resized to `wh` = (W, H) by
    Pillow's nearest-neighbour filter."""
    from PIL import Image

    return np.array(Image.fromarray(arr).resize(tuple(wh), Image.NEAREST))
