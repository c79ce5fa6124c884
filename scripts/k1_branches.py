"""K1's branches on one NVIDIA GPU without the rest of chip_smoke.py: its
phases 92-94 (K1 at every layer activation, the field-activation groups,
48 and 96 encoded columns, each against its plain version and timed),
and with `--longtail` / `--general` its phases 95 and 96; with `--forced`
first the flagship's chunk through K1's default and its generic
instantiation in turns (default, generic, generic, default), the same
leaky relu network in both, which prices the generic instantiation's
staging passes and smaller weight ring apart from any activation.

    python3 scripts/k1_branches.py [--forced] [--longtail] [--general]

Run from the root of a checkout (its kernels are built into its build/).
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("k1_branches needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, technicolor_z_plane)
    from hyperreel_tpu_torch.ops.kernels import build
    from hyperreel_tpu_torch.ops.kernels import pack_build as PB
    from hyperreel_tpu_torch.ops.kernels.shade import shade
    from hyperreel_tpu_torch.ops.kernels.shade_multi import shade_multi
    from hyperreel_tpu_torch.ops.kernels.shade_patch import shade_patch
    counted = (PB.pack_build, shade, shade_patch, shade_multi)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        return {fn.__name__: fn.launches for fn in counted}

    t0 = time.perf_counter()
    print(f"# kernels built in {build.load_library().build_seconds:.1f} s",
          flush=True)
    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    if "--forced" in sys.argv:
        base = convert_epochs_to_iters(technicolor_z_plane(), 4000)
        info = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
        default = PB.PackSpec.generic
        for forced in (False, True, True, False):
            if forced:
                PB.PackSpec.generic = lambda self, mlp, it: True
            try:
                cs.k1_variant(torch, dev, card,
                              f"leaky relu, generic instantiation {forced}",
                              base, info, frame[0], reset_counts,
                              read_counts)
            finally:
                PB.PackSpec.generic = default
    cs.k1_branch_phases(torch, dev, card, frame, reset_counts, read_counts)
    if "--longtail" in sys.argv:
        with tempfile.TemporaryDirectory() as tmp:
            cs.longtail_phase(torch, dev, card, reset_counts, read_counts,
                              tmp)
    if "--general" in sys.argv:
        cs.general_chain_phase(torch, dev, card, reset_counts, read_counts)
    print(f"# k1_branches took {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
