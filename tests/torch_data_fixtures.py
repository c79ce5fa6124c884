"""Small scenes of every dataset format, written from numpy seeds for the
data-layer parity tests (tests/test_torch_data_*.py): the shapes of
tests/test_datasets.py and tests/test_video_datasets.py, and the formats
no other test writes (stanford, spaces, catacaustics, video3d, the
variants). Images are PNG (Pillow), videos mp4 (cv2)."""

import json
import os

import numpy as np
from PIL import Image


def write_png(path, wh, seed, mode="RGB"):
    """A random image of `wh` = (W, H) in `mode` (RGB or RGBA)."""
    rng = np.random.default_rng(seed)
    arr = rng.uniform(0, 255, (wh[1], wh[0], len(mode))).astype(np.uint8)
    Image.fromarray(arr, mode).save(path)


def write_video(path, n_frames, wh, seed):
    """An mp4 of a random image rolled 2 pixels per frame."""
    import cv2

    rng = np.random.default_rng(seed)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, wh)
    if not vw.isOpened():
        raise OSError(f"cv2 cannot write {path}")
    base = rng.uniform(0, 255, (wh[1], wh[0], 3)).astype(np.uint8)
    for f in range(n_frames):
        vw.write(np.roll(base, f * 2, axis=1))
    vw.release()


def _poses_bounds(n, hwf, seed, step=0.1):
    """LLFF's poses_bounds.npy rows: [3 x 4 pose | hwf] flat, near, far;
    the cameras along x with a small random tilt."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 17))
    for i in range(n):
        pose = np.eye(4)[:3]
        pose[:, :3] += rng.normal(0, 0.02, (3, 3))
        pose[0, 3] = i * step
        pose[1, 3] = rng.normal(0, 0.01)
        rows[i, :15] = np.concatenate([pose, np.array(hwf)[:, None]],
                                      1).reshape(-1)
        rows[i, 15:] = [1.0 + 0.1 * i, 5.0]
    return rows


def _rotvec(rng, scale=0.1):
    return rng.normal(0, scale, 3).tolist()


def llff(root):
    d = os.path.join(root, "fern")
    os.makedirs(os.path.join(d, "images"))
    np.save(os.path.join(d, "poses_bounds.npy"),
            _poses_bounds(6, (24.0, 32.0, 30.0), 0))
    for i in range(6):
        write_png(os.path.join(d, "images", f"img_{i:03d}.png"), (32, 24),
                  seed=i)
    return d


def blender(root):
    """Four RGBA renders of 24 x 24 (loaded at 16 x 16: the premultiplied
    resize), one RGB; transforms for every split."""
    d = os.path.join(root, "lego")
    os.makedirs(os.path.join(d, "train"))
    rng = np.random.default_rng(3)
    frames = []
    for i in range(4):
        pose = np.eye(4)
        pose[:3, 3] = [0.2 * i, 0.1, 4.0]
        pose[:3, :3] += rng.normal(0, 0.02, (3, 3))
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": pose.tolist()})
        write_png(os.path.join(d, "train", f"r_{i}.png"), (24, 24),
                  seed=10 + i, mode="RGB" if i == 3 else "RGBA")
    for split in ("train", "val", "test"):
        with open(os.path.join(d, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911,
                       "frames": frames if split == "train" else frames[:2]},
                      f)
    return d


def donerf(root):
    """Two RGB views of 40 x 40 with 800 x 800 depth maps (the loader's
    size), a third with no depth."""
    d = os.path.join(root, "classroom")
    os.makedirs(d)
    rng = np.random.default_rng(4)
    frames = []
    for i in range(3):
        pose = np.eye(4)
        pose[:3, 3] = [0.1 * i, 0.0, 2.0]
        frames.append({"file_path": f"img_{i}",
                       "transform_matrix": pose.tolist()})
        write_png(os.path.join(d, f"img_{i}.png"), (40, 40), seed=20 + i)
        if i < 2:
            np.savez(os.path.join(d, f"img_{i}_depth.npz"),
                     depth=rng.uniform(0.5, 5.0, (800, 800)).astype(
                         np.float32))
    for split in ("train", "val", "test"):
        with open(os.path.join(d, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames}, f)
    with open(os.path.join(d, "dataset_info.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911, "depth_range": [0.5, 6.0],
                   "view_cell_center": [0.1, 0.0, 0.2],
                   "view_cell_size": [1, 1, 1]}, f)
    return d


def technicolor(root, n_frames=5, rows=2, cols=2, wh=(32, 16)):
    """A rows x cols rig of tilted cameras (random unit quaternions near
    the identity) over n_frames frames."""
    d = os.path.join(root, "painter")
    os.makedirs(os.path.join(d, "images"))
    rng = np.random.default_rng(5)
    lines = ["focal cx cy aspect skew qw qx qy qz d1 d2 tx ty tz\n"]
    for c in range(rows * cols):
        q = np.array([1.0, *rng.normal(0, 0.05, 3)])
        q /= np.linalg.norm(q)
        t = [0.1 * (c % cols), 0.1 * (c // cols), rng.normal(0, 0.01)]
        lines.append(" ".join(repr(float(v)) for v in [
            1000.0 + 10 * c, 1024.0, 544.0, 1.0, 0.0, *q, 0.0, 0.0, *t])
            + "\n")
    with open(os.path.join(d, "cameras_parameters.txt"), "w") as f:
        f.writelines(lines)
    for fi in range(n_frames):
        for c in range(rows * cols):
            write_png(os.path.join(d, "images",
                                   f"frame_{fi:04d}_cam_{c:02d}.png"),
                      wh, seed=100 + fi * 10 + c)
    return d


def neural_3d(root):
    d = os.path.join(root, "flame")
    os.makedirs(d)
    np.save(os.path.join(d, "poses_bounds.npy"),
            _poses_bounds(3, (48.0, 64.0, 50.0), 6, step=0.2))
    for i in range(3):
        write_video(os.path.join(d, f"cam{i:02d}.mp4"), 6, (64, 48), seed=i)
    return d


def immersive(root):
    d = os.path.join(root, "02_Flames")
    os.makedirs(d)
    rng = np.random.default_rng(7)
    cams = []
    for i in range(3):
        name = f"camera_{i + 1:04d}"
        cams.append({"name": name, "focal_length": 1000.0,
                     "principal_point": [1280.0, 960.0],
                     "radial_distortion": [0.1, 0.01, 0.0, 0.0],
                     "orientation": _rotvec(rng),
                     "position": [0.1 * i, 0.0, 0.0]})
        write_video(os.path.join(d, f"{name}.mp4"), 4, (64, 48), seed=30 + i)
    with open(os.path.join(d, "models.json"), "w") as f:
        json.dump(cams, f)
    return d


def stanford(root, rows=5, cols=5):
    d = os.path.join(root, "lego_lf")
    os.makedirs(d)
    for i in range(rows * cols):
        write_png(os.path.join(d, f"img_{i:03d}.png"), (16, 12),
                  seed=200 + i)
    return d


def spaces(root):
    """Two rigs of two cameras of 32 x 24 (loaded at 16 x 12), three
    train images and one val, planes.txt."""
    d = os.path.join(root, "scene_000")
    os.makedirs(os.path.join(d, "images"))
    rng = np.random.default_rng(8)
    rigs, names = [], []
    for r in range(2):
        rig = []
        for c in range(2):
            rel = f"images/rig{r}_cam{c}.png"
            write_png(os.path.join(d, rel), (32, 24), seed=300 + 2 * r + c)
            rig.append({"relative_path": rel, "width": 32, "height": 24,
                        "pixel_aspect_ratio": 1.0 + 0.05 * c,
                        "focal_length": 30.0,
                        "principal_point": [16.0, 12.0],
                        "orientation": _rotvec(rng),
                        "position": [0.1 * c, 0.05 * r, 0.0]})
            names.append(rel)
        rigs.append(rig)
    with open(os.path.join(d, "models.json"), "w") as f:
        json.dump(rigs, f)
    with open(os.path.join(d, "train_image.txt"), "w") as f:
        f.write("\n".join(names[:3]) + "\n")
    with open(os.path.join(d, "val_image.txt"), "w") as f:
        f.write(names[3] + "\n")
    with open(os.path.join(d, "planes.txt"), "w") as f:
        f.write("1.0 2.0 50.0")
    return d


def catacaustics(root):
    """bundle.out cameras with 24 x 16 images in cameras/ (3) and
    cameras_validation/ (1)."""
    d = os.path.join(root, "compost")
    rng = np.random.default_rng(9)
    for sub, n in (("cameras", 3), ("cameras_validation", 1)):
        folder = os.path.join(d, sub)
        os.makedirs(folder)
        lines = ["# Bundle file v0.3\n", f"{n} 0\n"]
        for i in range(n):
            R = np.eye(3) + rng.normal(0, 0.02, (3, 3))
            T = [0.1 * i, 0.0, -2.0]
            lines.append(f"{20.0 + i} 0 0\n")
            lines += [" ".join(repr(float(v)) for v in row) + "\n" for row in R]
            lines.append(" ".join(repr(float(v)) for v in T) + "\n")
            write_png(os.path.join(folder, f"{i:08d}.png"), (24, 16),
                      seed=400 + 10 * len(sub) + i)
        with open(os.path.join(folder, "bundle.out"), "w") as f:
            f.writelines(lines)
    return d


def _video3d_cameras(d, n, rng):
    os.makedirs(os.path.join(d, "cameras"))
    for i in range(n):
        c2w = np.eye(4)
        c2w[:3, :3] += rng.normal(0, 0.02, (3, 3))
        c2w[:3, 3] = [0.1 * i, 0.0, 2.0]
        meta = {"normalized_focal_length_x": 1.1,
                "normalized_focal_length_y": 1.2,
                "normalized_principal_point_x": 0.5,
                "normalized_principal_point_y": 0.5,
                "camera_to_world": c2w.tolist()}
        if i == 0:
            ref = np.eye(4)
            ref[:3, 3] = [0.0, 0.0, -0.5]
            meta["reference_world_to_camera"] = ref.tolist()
        with open(os.path.join(d, "cameras", f"cam_{i:03d}.json"), "w") as f:
            json.dump(meta, f)


def video3d_static(root):
    """Five views of 16 x 16 with depth maps of 8 x 8 (resized nearest)."""
    d = os.path.join(root, "v3d_static")
    os.makedirs(os.path.join(d, "images"))
    os.makedirs(os.path.join(d, "geometry"))
    rng = np.random.default_rng(10)
    _video3d_cameras(d, 5, rng)
    for i in range(5):
        write_png(os.path.join(d, "images", f"view_{i:03d}.png"), (16, 16),
                  seed=500 + i)
        np.savez(os.path.join(d, "geometry", f"view_{i:03d}_depth.npz"),
                 depth=rng.uniform(0.5, 5.0, (8, 8)).astype(np.float32))
    return d


def video3d_time(root):
    """Three frames of three views of 16 x 16, images/<frame>/<view>."""
    d = os.path.join(root, "v3d_time")
    rng = np.random.default_rng(11)
    _video3d_cameras(d, 3, rng)
    for fi in range(3):
        os.makedirs(os.path.join(d, "images", f"frame_{fi:03d}"))
        for v in range(3):
            write_png(os.path.join(d, "images", f"frame_{fi:03d}",
                                   f"view_{v:03d}.png"), (16, 16),
                      seed=600 + 10 * fi + v)
    return d


def write_all(root):
    """Every scene under `root`: {format: directory}."""
    return {name: fn(str(root)) for name, fn in (
        ("llff", llff), ("blender", blender), ("donerf", donerf),
        ("technicolor", technicolor), ("neural_3d", neural_3d),
        ("immersive", immersive), ("stanford", stanford),
        ("spaces", spaces), ("catacaustics", catacaustics),
        ("video3d_static", video3d_static),
        ("video3d_time", video3d_time))}
