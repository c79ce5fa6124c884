"""Top-level system: wires dataset + model + trainer + renderer + eval
(port of hyperreel_tpu/system.py; reference nlf/__init__.py INRSystem /
INRDataModule and main.py run()).

Everything runs on the System's device, the card unless the caller names
the CPU; a card that is asked for and not there is an error, not a
fallback. With `training.data_parallel=true` in a process group (torchrun
starts one process per card, each on cuda:LOCAL_RANK; a caller may join
one first, parallel/mesh.py initialize_multihost) `fit` takes
data-parallel steps (ShardedTrainer) and only rank 0 writes logs,
validation images and checkpoints; in a single process nothing changes.
Usage:
    python -m hyperreel_tpu_torch.main dataset.name=synthetic_blobs \
        model=tiny_static training.num_epochs=2
    torchrun --nproc_per_node 2 -m hyperreel_tpu_torch.main \
        training.data_parallel=true ...
"""

import json
import os
import time

import numpy as np
import torch

from hyperreel_tpu_torch.config import resolve_model_cfg
from hyperreel_tpu_torch.data import get_dataset
from hyperreel_tpu_torch.models.model import build_model
from hyperreel_tpu_torch.ops.pose_math import (
    create_spiral_poses, interpolate_poses)
from hyperreel_tpu_torch.ops.ray_math import (
    get_ndc_rays_fx_fy, get_ray_directions_K, get_rays)
from hyperreel_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
from hyperreel_tpu_torch.train.metrics import get_mean_outputs, psnr, ssim
from hyperreel_tpu_torch.train.render import Renderer
from hyperreel_tpu_torch.train.trainer import Trainer
from hyperreel_tpu_torch.train.visualizers import build_visualizers

# the seed of the steps' generator (the JAX System's PRNGKey(1234))
_STEP_SEED = 1234


def write_video(path, frames, fps=24):
    """Write uint8 RGB frames to an mp4 (reference logs validation videos
    via imageio/wandb, nlf/__init__.py validation_video). Where no mp4
    encoder opens, says so and keeps the PNG frames only (returns None)."""
    try:
        import cv2
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError("VideoWriter failed to open")
        for fr in frames:
            writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
        writer.release()
        return path
    except Exception as e:  # no cv2, no encoder: the frames stay
        print(f"video writer unavailable ({e}); keeping PNG frames only")
        return None


def _save_pngs(jobs):
    """Write [(path, uint8 image)] as PNGs, a thread per host CPU: Pillow's
    encoder releases the interpreter lock, and the encoding (~1 s for a
    2048 x 1088 frame) is most of what validation and the spiral spend on
    the host."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image

    def save(job):
        Image.fromarray(job[1]).save(job[0])

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        for fut in [ex.submit(save, job) for job in jobs]:
            fut.result()


def _to_u8(img):
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class System:
    def __init__(self, cfg, device="cuda"):
        from hyperreel_tpu_torch.parallel import mesh
        self.cfg = cfg
        self.device = mesh.rank_device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible: run with --device "
                               "cpu for the CPU")
        ds_cfg = dict(cfg["dataset"])
        self._ds_name = ds_cfg.pop("name")
        self._ds_root = ds_cfg.pop("root_dir", None)
        self._use_raystore = bool(ds_cfg.pop("use_raystore", False))
        self._ds_cfg = ds_cfg
        self.train_dataset = self._load_dataset("train")
        try:
            self.val_dataset = self._load_dataset("val")
        except Exception:  # a loader without a val split: train is val
            self.val_dataset = self.train_dataset

        tcfg = cfg["training"]
        if tcfg.get("sample_with_replacement", True):
            self.iters_per_epoch = int(tcfg.get("num_iters", 4000))
        else:
            self.iters_per_epoch = int(np.ceil(
                self.train_dataset.num_rays / tcfg["batch_size"]))

        # data-parallel training (training.data_parallel=true) in a
        # process group, as the JAX System over more than one device
        # (hyperreel_tpu/system.py:82-90); a single process trains alone
        data_parallel = tcfg.get("data_parallel", False) and (
            torch.distributed.is_initialized()
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)
        self.rank = 0
        if data_parallel:
            self.rank, world = mesh.initialize_multihost(self.device)
            print(f"data-parallel: rank {self.rank} of {world} on "
                  f"{self.device}")

        model_cfg = resolve_model_cfg(cfg, self.iters_per_epoch)
        dtype_name = cfg["params"].get("compute_dtype", None)
        self.compute_dtype = {"bfloat16": torch.bfloat16,
                              "float32": None}.get(dtype_name, None)
        self.model = build_model(model_cfg,
                                 dataset_info=self.train_dataset.info(),
                                 compute_dtype=self.compute_dtype)
        self.trainer = Trainer(
            self.model, tcfg, regularizer_cfgs=cfg.get("regularizers"),
            iters_per_epoch=self.iters_per_epoch, device=self.device)
        self.trainer.system = self  # pose-aware regularizers
        self.sharded = mesh.ShardedTrainer(self.trainer) if data_parallel \
            else None
        self.renderer = Renderer(self.model,
                                 ray_chunk=int(tcfg.get("ray_chunk", 65536)),
                                 device=self.device)
        self.visualizers = build_visualizers(cfg.get("visualizers"))
        self.save_dir = os.path.join(
            cfg["params"].get("save_dir", "runs"),
            cfg["params"].get("name", "experiment"))
        os.makedirs(self.save_dir, exist_ok=True)

    def _load_dataset(self, split, scale=1):
        kwargs = dict(self._ds_cfg)
        if scale != 1 and "wh" in kwargs:
            kwargs["wh"] = [max(v // scale, 4) for v in kwargs["wh"]]
        elif scale != 1 and "img_wh" in kwargs:
            kwargs["img_wh"] = [max(v // scale, 4) for v in kwargs["img_wh"]]
        elif scale != 1:
            kwargs["downsample"] = int(kwargs.get("downsample", 1)) * scale
        args = [self._ds_root] if self._ds_root else []
        if split != "train":
            kwargs = {k: v for k, v in kwargs.items() if k != "split"}
            kwargs["split"] = split
        return get_dataset(self._ds_name, *args, device=self.device,
                           **kwargs)

    def update_data(self, epoch):
        """Multiscale schedule (reference INRDataModule.update_data,
        nlf/__init__.py:187-220 + training cfg multiscale/scales/
        scale_epochs): reload the train set at the scheduled scale."""
        tcfg = self.cfg["training"]
        if not tcfg.get("multiscale", False):
            return False
        scales = tcfg.get("scales", [1])
        scale_epochs = tcfg.get("scale_epochs", [0])
        cur = scales[0]
        for s, e in zip(scales, scale_epochs):
            if epoch >= e:
                cur = s
        if getattr(self, "_cur_scale", None) != cur:
            self._cur_scale = cur
            self.train_dataset = self._load_dataset("train", scale=cur)
            return True
        return False

    # -- training ----------------------------------------------------------

    def init_state(self):
        """A fresh TrainState from a torch.Generator seeded with
        params.seed."""
        seed = int(self.cfg["params"].get("seed", 0))
        return self.trainer.init_state(torch.Generator().manual_seed(seed))

    def fit(self, resume_from=None):
        cfg = self.cfg["training"]
        seed = int(self.cfg["params"].get("seed", 0))
        if resume_from:
            state = restore_checkpoint(resume_from, self.trainer)
        else:
            state = self.init_state()

        total_iters = int(cfg.get("num_epochs", 40)) * self.iters_per_epoch
        batch_size = int(cfg.get("batch_size", 16384))
        log_every = int(cfg.get("log_every", 100))
        val_every = int(cfg.get("val_every", 10)) * self.iters_per_epoch
        ckpt_every = int(cfg.get("ckpt_every", 40)) * self.iters_per_epoch

        # regularizers with host-side batch needs (teacher datasets,
        # reference nlf/regularizers/teacher.py get_dataset/get_batch)
        host_regs = [r for _, r in self.trainer.regularizers
                     if hasattr(r, "host_batch")]

        writer = self.rank == 0

        def batches():
            if self._use_raystore:
                # the rays spilled to a file and sampled by the native
                # sampler (data/raystore.py; large dynamic scenes); rank 0
                # writes the file, the other ranks open it
                from hyperreel_tpu_torch.data.raystore import MmapRayStore
                path = os.path.join(self.save_dir, "raystore.npy")
                if writer:
                    store = MmapRayStore.create(path, self.train_dataset)
                if self.sharded is not None:
                    torch.distributed.barrier()
                if not writer:
                    store = MmapRayStore(
                        path, self.train_dataset.all_coords.shape[-1])
                it = store.batch_iterator(batch_size, seed=seed)
            else:
                it = self.train_dataset.batch_iterator(batch_size, seed=seed)
            for b in it:
                for reg in host_regs:
                    b.update(reg.host_batch(self))
                yield b

        batch_iter = batches()
        gen = torch.Generator(device=self.device).manual_seed(_STEP_SEED)
        fitter = self.trainer
        if self.sharded is not None:
            state = self.sharded.place_state(state)
            fitter = self.sharded
        metrics_log = []
        t_start = time.time()

        while state.it < total_iters:
            if self.update_data(state.it // self.iters_per_epoch):
                batch_iter = batches()
            chunk = min(val_every, total_iters - state.it)
            state, history = fitter.fit(
                state, batch_iter, num_iters=chunk, gen=gen,
                log_every=log_every,
                callback=lambda m: writer and print(
                    f"it {m['it']}: loss {m['loss']:.5f} "
                    f"psnr {m['psnr']:.2f}"))
            metrics_log += history
            if not writer:
                continue
            # one JSON object per logged step (the reference's
            # TensorBoard scalars, main.py:94)
            with open(os.path.join(self.save_dir, "metrics.jsonl"),
                      "a") as f:
                for m in history:
                    f.write(json.dumps(m) + "\n")
            val_metrics = self.validate(state, max_images=2)
            print(f"[val @ it {state.it}] {val_metrics}")
            with open(os.path.join(self.save_dir, "metrics.txt"), "a") as f:
                f.write(json.dumps({"it": state.it, **val_metrics}) + "\n")
            if ckpt_every and state.it % ckpt_every == 0:
                save_checkpoint(
                    os.path.join(self.save_dir, "last"), state, self.model)

        if writer:
            save_checkpoint(os.path.join(self.save_dir, "last"), state,
                            self.model)
            print(f"training done in {time.time() - t_start:.1f}s")
        return state, metrics_log

    # -- evaluation (reference nlf/__init__.py:895-1028) ---------------------

    def validate(self, state, max_images=None, save_images=False):
        ds = self.val_dataset
        n = ds.num_images if max_images is None else min(
            ds.num_images, max_images)
        # LPIPS (reference metrics.py:54-58) where a weights file exists
        # (train/lpips.py: the weights cannot be downloaded)
        from hyperreel_tpu_torch.train import lpips as lpips_mod
        lpips_params = None
        lpips_path = lpips_mod.default_weights_path(self.cfg.get("params"))
        if lpips_path and os.path.isfile(lpips_path):
            lpips_params = lpips_mod.load_weights(lpips_path, self.device)
        outs, pngs = [], []
        for i in range(n):
            img_batch = ds.image(i)
            out = self.renderer.render_image(
                state.params, img_batch["rays"], ds.img_wh, it=state.it)
            W, H = ds.img_wh
            gt = img_batch["rgb"].reshape(H, W, 3)
            pred = np.clip(out["rgb"], 0, 1)
            pred_t = torch.as_tensor(pred, device=self.device)
            gt_t = torch.as_tensor(gt, device=self.device)
            m = {"psnr": float(psnr(pred_t, gt_t)),
                 "ssim": float(ssim(pred_t, gt_t))}
            if lpips_params is not None:
                m["lpips"] = float(lpips_mod.lpips(lpips_params, pred_t,
                                                   gt_t))
            outs.append(m)
            if save_images or self.visualizers:
                img_dir = os.path.join(self.save_dir, "val_images",
                                       str(state.it))
                os.makedirs(img_dir, exist_ok=True)
            if save_images:
                pngs += [(os.path.join(img_dir, f"pred_{i:03d}.png"),
                          (pred * 255).astype(np.uint8)),
                         (os.path.join(img_dir, f"gt_{i:03d}.png"),
                          (gt * 255).astype(np.uint8))]
            if i == 0 and self.visualizers:
                for name, vis in self.visualizers:
                    try:
                        images = vis.render(self, state, img_batch["rays"],
                                            ds.img_wh)
                    except Exception as e:  # visualizers must not kill eval
                        print(f"visualizer {name} failed: {e}")
                        continue
                    pngs += [(os.path.join(img_dir, f"{key}.png"),
                              _to_u8(img)) for key, img in images.items()]
        _save_pngs(pngs)
        return get_mean_outputs(outs)

    def render_path_poses(self, n_poses=30, interpolate=False):
        """Render-path camera poses and intrinsics.

        When the dataset exposes real train poses, mirror the reference's
        prepare_render_data (datasets/base.py:447-459): spiral radii from the
        90th percentile of |pose translations| and focus depth from the
        harmonic mean of the scene depth bounds. Otherwise a synthetic
        forward-facing ring.
        """
        ds = self.train_dataset
        W, H = ds.img_wh
        if ds.poses is not None and len(ds.poses) > 0:
            base = np.asarray(ds.poses, np.float32)
            K = np.asarray(ds.intrinsics, np.float32)
            if interpolate:
                return interpolate_poses(base, n_poses), K
            near, far = ds.depth_range
            close_depth, inf_depth = near * 0.9, far * 5.0
            dt = 0.75
            focus_depth = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
            radii = np.percentile(np.abs(base[..., 3]), 90, axis=0)
            return create_spiral_poses(base, radii, focus_depth,
                                       N=n_poses), K
        f = 1.2 * W
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        base = np.stack([np.concatenate(
            [np.eye(3), np.array([[0.0], [0.0], [2.0]])], 1)] * 3)
        if interpolate:
            return interpolate_poses(base, n_poses), K
        return create_spiral_poses(base, [0.2, 0.2, 0.1], focal=1.5,
                                   N=n_poses), K

    def render_spiral(self, state, n_poses=30, save_frames=True,
                      interpolate=False, save_video=True, fps=24):
        """Spiral-path (or pose-interpolated) video render (reference
        validation_video, nlf/__init__.py:809-893; render_params
        interpolate option). Writes frames as PNGs and an mp4 video;
        returns (the uint8 frames, each frame's render seconds)."""
        ds = self.train_dataset
        W, H = ds.img_wh
        poses, K = self.render_path_poses(n_poses, interpolate)
        frames = []
        times = []
        num_frames = max(getattr(ds, "num_frames", 1), 1)
        dirs = get_ray_directions_K(H, W, K, centered_pixels=True)
        for i, pose in enumerate(poses):
            rays_o, rays_d = get_rays(dirs, pose[:3, :4])
            rays = np.concatenate([rays_o, rays_d], -1).astype(np.float32)
            if ds.ndc_params is not None:
                fx, fy, ndc_near = ds.ndc_params
                rays = get_ndc_rays_fx_fy(
                    H, W, fx, fy, ndc_near, rays).astype(np.float32)
            ray_width = ds.all_coords.shape[-1]
            if ray_width == 8:
                # snapped frame times along the path (reference
                # Base6DDataset.prepare_render_data, datasets/base.py:545-556)
                t = i / max(len(poses) - 1, 1)
                t = np.round(t * (num_frames - 1)) / max(num_frames - 1, 1)
                rays = np.concatenate([
                    rays, np.ones((rays.shape[0], 1), np.float32),
                    np.full((rays.shape[0], 1), t, np.float32)], -1)
            elif ray_width == 7:
                rays = np.concatenate([
                    rays, np.ones((rays.shape[0], 1), np.float32)], -1)
            t0 = time.time()
            out = self.renderer.render_image(state.params, rays,
                                             ds.img_wh, it=state.it)
            times.append(time.time() - t0)
            frames.append(_to_u8(out["rgb"]))
        print(f"mean frame time: {np.mean(times[1:]):.3f}s")
        vid_dir = os.path.join(self.save_dir, "spiral")
        if save_frames:
            os.makedirs(vid_dir, exist_ok=True)
            _save_pngs([(os.path.join(vid_dir, f"{i:04d}.png"), fr)
                        for i, fr in enumerate(frames)])
        if save_video:
            os.makedirs(vid_dir, exist_ok=True)
            write_video(os.path.join(vid_dir, "spiral.mp4"), frames, fps)
        return frames, times
