"""Packaging of the PyTorch port: it imports no JAX, no Triton, nothing
of the JAX package (its presets are its own copy, held equal to the JAX
package's here) and, until a loader reads a file, neither Pillow nor cv2;
its ray store's sampler is built from its own source; and chip_smoke.py
refuses to run (non-zero exit, no result line) without a CUDA card or
without the repository beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu_torch.configs import presets as TP

ROOT = Path(__file__).resolve().parents[1]


def _run(code_or_script, cwd, script=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT) if not script else "")
    args = [sys.executable, code_or_script] if script \
        else [sys.executable, "-c", code_or_script]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax():
    """Every module of the port (the CLI, System, viewer, chunked renderer,
    export, visualizers and the other colour nets among them),
    chip_smoke.py's imports (and its model build, which reads the presets)
    and the profile script's."""
    res = _run(
        "import importlib, pkgutil, sys\n"
        "import hyperreel_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    hyperreel_tpu_torch.__path__, 'hyperreel_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "import chip_smoke\n"
        "chip_smoke.flagship(torch.device('cpu'))\n"
        "sys.path.insert(0, 'scripts')\n"
        "import profile_torch_frame\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'triton',\n"
        "       'hyperreel_tpu', 'PIL', 'cv2') or m.startswith(('jax.',\n"
        "       'jaxlib.', 'triton.', 'hyperreel_tpu.', 'PIL.', 'cv2.'))]\n"
        "assert not bad, bad\n"
        "assert len(mods) > 25, mods\n"
        "assert {'hyperreel_tpu_torch.ops.kernels.shade_multi',\n"
        "        'hyperreel_tpu_torch.ops.kernels.shade_multi_patch',\n"
        "        'hyperreel_tpu_torch.ops.contract',\n"
        "        'hyperreel_tpu_torch.data.technicolor',\n"
        "        'hyperreel_tpu_torch.data.raystore',\n"
        "        'hyperreel_tpu_torch.main', 'hyperreel_tpu_torch.system',\n"
        "        'hyperreel_tpu_torch.viewer', 'hyperreel_tpu_torch.config',\n"
        "        'hyperreel_tpu_torch.configs.reference_yaml',\n"
        "        'hyperreel_tpu_torch.ops.marching_cubes',\n"
        "        'hyperreel_tpu_torch.train.render',\n"
        "        'hyperreel_tpu_torch.train.export',\n"
        "        'hyperreel_tpu_torch.train.lpips',\n"
        "        'hyperreel_tpu_torch.train.visualizers',\n"
        "        'hyperreel_tpu_torch.models.tensorf_extra',\n"
        "        'hyperreel_tpu_torch.models.embeddings',\n"
        "        'hyperreel_tpu_torch.ops.render_math'} <= set(mods), mods\n"
        "print('clean')\n", cwd=ROOT)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_ray_store_builds_from_the_ports_source(tmp_path):
    """The port's sampler is compiled from hyperreel_tpu_torch/csrc/
    raystore.cpp into the given build directory, not from native/."""
    from hyperreel_tpu_torch.data import raystore

    assert raystore.SOURCE == ROOT / "hyperreel_tpu_torch" / "csrc" / \
        "raystore.cpp"
    assert raystore.BUILD_DIR == ROOT / "build" / "hyperreel_tpu_torch"
    raystore.load_library(tmp_path)
    assert (tmp_path / raystore.LIB_NAME).exists()


@pytest.mark.parametrize("name,make", [
    ("technicolor_z_plane", lambda P: P.technicolor_z_plane()),
    ("technicolor_z_plane_z16", lambda P: P.technicolor_z_plane(16)),
    ("tiny_dynamic", lambda P: P.tiny_dynamic()),
    ("tiny_dynamic_z4_grid16", lambda P: P.tiny_dynamic(4, 16)),
    ("bench_patch_route", lambda P: P.with_coherent_gather(
        P.technicolor_z_plane(), 5, 2, 8)),
    ("default_patch_route", lambda P: P.with_coherent_gather(
        P.tiny_dynamic())),
    ("epochs_to_iters", lambda P: P.convert_epochs_to_iters(
        P.technicolor_z_plane(), 4000)),
    ("llff_z_plane", lambda P: P.llff_z_plane()),
    ("llff_z_plane_z16", lambda P: P.llff_z_plane(16)),
    ("tiny_static", lambda P: P.tiny_static()),
    ("tiny_static_z32_grid16", lambda P: P.tiny_static(32, 16)),
    ("llff_patch_route", lambda P: P.with_coherent_gather(
        P.llff_z_plane(), 5, 2, 8)),
    ("llff_epochs_to_iters", lambda P: P.convert_epochs_to_iters(
        P.llff_z_plane(), 4000)),
    ("neural_3d_z_plane", lambda P: P.neural_3d_z_plane()),
    ("neural_3d_z_plane_z32", lambda P: P.neural_3d_z_plane(32)),
    ("tiny_neural_3d", lambda P: P.tiny_neural_3d()),
    ("tiny_neural_3d_z64_grid16", lambda P: P.tiny_neural_3d(64, 16)),
    ("n3d_patch_route", lambda P: P.with_coherent_gather(
        P.neural_3d_z_plane(), 5, 3, 8)),
    ("n3d_epochs_to_iters", lambda P: P.convert_epochs_to_iters(
        P.neural_3d_z_plane(), 4000)),
    ("shiny_z_plane", lambda P: P.shiny_z_plane()),
    ("shiny_z_plane_z16", lambda P: P.shiny_z_plane(16)),
    ("shiny_patch_route", lambda P: P.with_coherent_gather(
        P.shiny_z_plane(), 5, 2, 8)),
    ("stanford_llff_z_plane", lambda P: P.stanford_llff_z_plane()),
    ("stanford_epochs_to_iters", lambda P: P.convert_epochs_to_iters(
        P.stanford_llff_z_plane(), 4000)),
    # the port's tiny RGB presets keep bf16 tables (the fused routes need
    # them), where the JAX package's turn the tables off
    ("tiny_shiny", lambda P: P.tiny_shiny() if P is TP else _bf16_tables(
        P.tiny_shiny())),
    ("tiny_shiny_no_stages", lambda P: P.tiny_shiny(sample_stages=False)
     if P is TP else _bf16_tables(P.tiny_shiny(sample_stages=False))),
    ("shiny_z_plane_stages", lambda P: P.shiny_z_plane(16,
                                                       sample_stages=True)),
    ("tiny_stanford_llff", lambda P: P.tiny_stanford_llff() if P is TP
     else _bf16_tables(P.tiny_stanford_llff())),
    ("donerf_sphere", lambda P: P.donerf_sphere()),
    ("donerf_cylinder", lambda P: P.donerf_cylinder()),
    ("catacaustics_distance", lambda P: P.catacaustics_distance()),
    ("catacaustics_distance_z32", lambda P: P.catacaustics_distance(32)),
    ("immersive_sphere_new", lambda P: P.immersive_sphere_new()),
    ("immersive_epochs_to_iters", lambda P: P.convert_epochs_to_iters(
        P.immersive_sphere_new(), 4000)),
    # the port's tiny primitive presets keep bf16 tables (the own fused
    # routes need them)
    ("tiny_donerf_sphere", lambda P: P.tiny_donerf_sphere() if P is TP
     else _bf16_tables(P.tiny_donerf_sphere())),
    ("tiny_donerf_cylinder", lambda P: P.tiny_donerf_cylinder() if P is TP
     else _bf16_tables(P.tiny_donerf_cylinder())),
    ("tiny_catacaustics_distance", lambda P: P.tiny_catacaustics_distance()
     if P is TP else _bf16_tables(P.tiny_catacaustics_distance())),
    ("tiny_immersive_sphere", lambda P: P.tiny_immersive_sphere() if P is TP
     else _bf16_tables(P.tiny_immersive_sphere())),
    # the render-time sample-count stages
    ("flagship_compact16", lambda P: P.with_compact_samples(
        P.technicolor_z_plane(), 16)),
    ("flagship_compact_always", lambda P: P.with_compact_samples(
        P.tiny_dynamic(), 4, always=True)),
    ("flagship_stride8", lambda P: P.with_inference_samples(
        P.technicolor_z_plane(), 8)),
    ("n3d_stride16", lambda P: P.with_inference_samples(
        P.neural_3d_z_plane(), 16)),
    ("n3d_compact16", lambda P: P.with_compact_samples(
        P.neural_3d_z_plane(), 16)),
    ("shiny_compact16", lambda P: P.with_compact_samples(
        P.shiny_z_plane(), 16)),
    ("shiny_stride8", lambda P: P.with_inference_samples(
        P.shiny_z_plane(), 8)),
    ("llff_compact_patch", lambda P: P.with_coherent_gather(
        P.with_compact_samples(P.llff_z_plane(), 16), 5, 2, 8)),
    # the cascaded, voxel, deformable and reflect families
    ("technicolor_cascaded", lambda P: P.technicolor_cascaded()),
    ("cascaded_epochs_to_iters", lambda P: P.convert_epochs_to_iters(
        P.technicolor_cascaded(), 4000)),
    ("tiny_cascaded", lambda P: P.tiny_cascaded()),
    ("blender_voxel", lambda P: P.blender_voxel()),
    ("tiny_blender_voxel", lambda P: P.tiny_blender_voxel()),
    ("shiny_z_deformable", lambda P: P.shiny_z_deformable()),
    ("tiny_shiny_deformable", lambda P: P.tiny_shiny_deformable()
     if P is TP else _bf16_tables(P.tiny_shiny_deformable())),
    ("refnerf_sphere", lambda P: P.refnerf_sphere()),
    ("refnerf_sphere_reflect", lambda P: P.refnerf_sphere_reflect()),
    ("tiny_refnerf_reflect", lambda P: P.tiny_refnerf_reflect() if P is TP
     else _bf16_tables(P.tiny_refnerf_reflect())),
])
def test_presets_equal_the_jax_packages(name, make):
    assert make(TP) == make(JP)


def _bf16_tables(cfg):
    cfg["color"]["net"]["bf16_tables"] = True
    return cfg


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    results = []
    if not torch.cuda.is_available():
        results.append(_run(str(ROOT / "chip_smoke.py"), ROOT, script=True))
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    results.append(_run(str(alone), tmp_path, script=True))
    for res in results:
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
