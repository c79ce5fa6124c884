"""CLI entry (port of hyperreel_tpu/main.py; reference main.py).

    python -m hyperreel_tpu_torch.main [--config cfg.yaml] [key=value ...]
        [--render-only] [--eval-only] [--resume PATH] [--export-mesh PLY]
        [--interact [--fast-samples K] [--coherent-gather]]
        [--device cuda|cpu]

Overrides use the reference's Hydra-style dotted syntax
(`training.num_epochs=2 dataset.name=llff dataset.root_dir=/data/fern`).
Everything runs on `--device`, the card by default; `--device cpu` runs on
the CPU. Data-parallel training over the cards of one host: torchrun
with one process per card (its nproc_per_node), each on cuda:LOCAL_RANK,
only rank 0 writing and validating:

    torchrun ... -m hyperreel_tpu_torch.main training.data_parallel=true \
        [key=value ...]
"""

import argparse
import time

import torch


def viewer_models(system, state, fast_samples=-1, coherent_gather=False):
    """The viewer's (model, params, patch_model, probe dB) for a System's
    state: with fast_samples K > 0 a model that renders K samples per ray
    (the first K after the intersect's sort where it sorts invalid samples
    far, else every (S/K)-th); -1 picks compaction to 16 behind
    `fast_mode_probe`'s quality gate where the model sorts them far, full
    samples otherwise (the probe's compact-vs-full dB is returned, None
    where no probe ran); 0 keeps full samples. With coherent_gather, the
    patch-gather clone of the model the viewer gates per ladder level."""
    from hyperreel_tpu_torch.config import resolve_model_cfg
    from hyperreel_tpu_torch.configs.presets import (
        with_coherent_gather, with_compact_samples, with_inference_samples)
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.viewer import fast_mode_probe

    model, params = system.model, state.params
    mcfg = resolve_model_cfg(system.cfg, system.iters_per_epoch)
    info = system.train_dataset.info()

    def build(cfg):
        # a clone of the system's model: the grid events' aabb and grid
        # size of the state, not the config's
        m = build_model(cfg, dataset_info=info,
                        compute_dtype=system.compute_dtype)
        m.color_net.aabb = model.color_net.aabb
        m.color_net.grid_size = list(model.color_net.grid_size)
        return m
    k = fast_samples
    if k:
        far = any(
            st.get("type") == "ray_intersect"
            and st.get("intersect", {}).get("invalid_sort_far")
            for st in mcfg["embedding"]["embeddings"].values())
        auto = k == -1
        if auto:
            # compaction only after a scene-dependent quality probe (a
            # scene with hostile occluders collapses under it); the
            # stride needs a fine-tune, so auto keeps full samples on
            # models that cannot compact
            k = 16 if far else 0
    probe_db = None
    if k > 0:
        helper = with_compact_samples if far else with_inference_samples
        fast_cfg = helper(mcfg, k)
        fast_model = build(fast_cfg)
        init_p = fast_model.init(torch.Generator().manual_seed(0),
                                 system.device)
        emb = dict(init_p["embedding"])
        emb.update(params["embedding"])
        fast_params = dict(params, embedding=emb)
        probe_ok = True
        if auto:
            probe_ok, probe_db = fast_mode_probe(
                model, params, fast_model, fast_params,
                system.train_dataset.all_coords, it=state.it,
                device=system.device)
            print(f"viewer fast-mode probe: compact-vs-full "
                  f"{probe_db:.1f} dB ({'pass' if probe_ok else 'FAIL'} "
                  "@ 35.0 gate)")
        if probe_ok:
            mcfg, model, params = fast_cfg, fast_model, fast_params
            print(f"viewer fast mode: {k} samples/ray "
                  f"({'compact' if far else 'stride'})")
        else:
            print("viewer fast mode disabled by quality gate "
                  "(scene-dependent compact loss; use --fast-samples to "
                  "force)")
    patch_model = None
    if coherent_gather:
        patch_model = build(with_coherent_gather(mcfg))
        print("viewer coherent patch-gather on (gated per ladder level by "
              "the coverage bound)")
    return model, params, patch_model, probe_db


def main(argv=None):
    """Run the CLI on `argv`; returns (the System, its final TrainState,
    what the run computed) to an in-process caller (None for --interact,
    which serves until interrupted). What it computed is a dict of the
    actions it took: "fit" (wall seconds) and "final" (the validation's
    metrics) after training; "mesh" (verts, faces, seconds), "eval"
    (metrics, seconds) and "spiral" (the frames' render seconds, seconds)
    from a checkpoint."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--render-only", action="store_true",
                        help="skip training; render spiral from checkpoint")
    parser.add_argument("--eval-only", action="store_true",
                        help="skip training; run full validation (all val "
                             "images, saved PNGs + metrics) from checkpoint")
    parser.add_argument("--resume", default=None,
                        help="checkpoint dir to resume/render from")
    parser.add_argument("--import-reference", default=None, metavar="CKPT",
                        help="initialize weights from a reference "
                             "(facebookresearch/hyperreel) .ckpt file (not "
                             "ported: ROADMAP.md long tail)")
    parser.add_argument("--export-mesh", default=None, metavar="PLY",
                        help="with --resume: extract the density-field "
                             "isosurface mesh to a PLY file "
                             "(reference utils/tensorf_utils.py:170-229)")
    parser.add_argument("--interact", action="store_true",
                        help="serve the interactive browser viewer from a "
                             "checkpoint (the reference's interact_only "
                             "NeRFGUI mode, utils/gui_utils.py:74)")
    parser.add_argument("--fast-samples", type=int, default=-1,
                        metavar="K",
                        help="viewer fast mode: render with K samples/ray "
                             "(the first K after the sort when the model "
                             "trained with intersect invalid_sort_far, "
                             "else every (S/K)-th). Default -1 = auto: "
                             "compact K=16 behind a quality probe when the "
                             "model can compact, full samples otherwise; "
                             "0 = always full")
    parser.add_argument("--coherent-gather", action="store_true",
                        help="viewer: patch-row gather (one row per "
                             "R-ray block, ops/patch_gather.py), gated per "
                             "ladder level by an analytic coverage bound: "
                             "high-density levels take the patch route, "
                             "low levels keep the exact quad route")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu "
                             "for the CPU)")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)

    from hyperreel_tpu_torch.config import load_config
    from hyperreel_tpu_torch.system import System
    from hyperreel_tpu_torch.train.checkpoint import restore_checkpoint

    if args.import_reference:
        raise NotImplementedError(
            "--import-reference: tools/import_reference_ckpt.py is not "
            "ported (ROADMAP.md: long tail)")

    cfg = load_config(args.config, args.overrides)
    print("config:", cfg)
    system = System(cfg, device=args.device)

    if args.interact:
        from hyperreel_tpu_torch.viewer import serve
        state = restore_checkpoint(args.resume, system.trainer) \
            if args.resume else system.init_state()
        model, params, patch_model, _ = viewer_models(
            system, state, args.fast_samples, args.coherent_gather)
        serve(model, params,
              ray_width=system.train_dataset.all_coords.shape[-1],
              patch_model=patch_model, device=system.device)
        return None

    if args.render_only or args.eval_only or args.export_mesh:
        if not args.resume:
            raise ValueError(
                "--render-only/--eval-only/--export-mesh require --resume")
        state = restore_checkpoint(args.resume, system.trainer)
        results = {}
        if args.export_mesh:
            from hyperreel_tpu_torch.train.export import export_mesh_ply
            t0 = time.perf_counter()
            nv, nf = export_mesh_ply(args.export_mesh,
                                     system.model.color_net,
                                     state.params["color"])
            results["mesh"] = {"verts": nv, "faces": nf,
                               "seconds": time.perf_counter() - t0}
            print(f"mesh: {nv} verts, {nf} faces -> {args.export_mesh}")
        if args.eval_only:
            t0 = time.perf_counter()
            metrics = system.validate(state, save_images=True)
            results["eval"] = {"metrics": metrics,
                               "seconds": time.perf_counter() - t0}
            print("eval:", metrics)
        if args.render_only:
            t0 = time.perf_counter()
            _, frame_s = system.render_spiral(state)
            results["spiral"] = {"frame_seconds": frame_s,
                                 "seconds": time.perf_counter() - t0}
        return system, state, results

    t0 = time.perf_counter()
    state, _ = system.fit(resume_from=args.resume)
    fit_s = time.perf_counter() - t0
    if system.rank != 0:
        return system, state, {"fit": fit_s}
    metrics = system.validate(state)
    print("final:", metrics)
    return system, state, {"fit": fit_s, "final": metrics}


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
