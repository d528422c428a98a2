"""Full-width phases of ``chip_smoke.py`` alone: the serving protocol
(phase 4, ``main_path``), the AF-VAE training path (phase 8,
``vae_train``), the SD image interpolation (phase 12, ``sd_interp``), the
video editing (phase 20, ``video_edit``), the normal estimation (phase
22, ``normal``), the tiny card-vs-CPU checks of the I2SB, SD text and
normal-ControlNet trainers, the text encoder and the SD pipeline round
trip (phases 23-25, ``tiny_trainers``) and those three trainers at full
width (phase 26: ``i2sb_train``, ``sd_text_train``, ``norm_train``),
the precision check and the AF-VAE trainer at each ``af_precision``
level (phases 31 and 32: ``af_precision``, ``af_vae``), and the serving
protocol and the FFHQ interp on a bf16 pipeline (phases 34 and 35:
``bf16_protocol``, ``bf16_interp``), with their wall times, peak device
memory and launch counts, without the other phases. Run it as a file from the root of the
checkout to measure, so that two commits' end-to-end times can be taken in
turns within one call on one card:

    python afldm_tpu_torch/scripts/phase_check.py main_path sd_interp
    cd <other checkout> && python \\
        <this checkout>/afldm_tpu_torch/scripts/phase_check.py main_path

Prints chip_smoke's own lines for each run of a phase (``--repeat`` runs
each several times in one process, the first including the cold start;
``--shapes`` adds the input shapes each filtered-activation kernel was
called with, and how often) and exits non-zero if a run fails.
"""

import argparse
import importlib
import sys
from pathlib import Path

PHASES = ("main_path", "vae_train", "sd_interp", "video_edit", "normal",
          "tiny_trainers", "i2sb_train", "sd_text_train", "norm_train",
          "af_precision", "af_vae", "bf16_protocol", "bf16_interp")
# the full-width trainer of each trainer phase
TRAINER_PHASES = {"i2sb_train": "i2sb", "sd_text_train": "sd_text",
                  "norm_train": "norm_controlnet"}
# the filtered-activation wrappers that launch a kernel (K5, K5b, K1, K2),
# each called with its input first
FILTERED_ACT_ENTRIES = ("_plane_forward", "filtered_act_plane_bwd",
                        "_banded_forward", "filtered_act_banded_bwd")


def count_shapes(fa, seen: dict):
    """Wraps each of FILTERED_ACT_ENTRIES in the module ``fa`` so that a
    call adds one to seen[(name, shape of its input)]."""
    def counted(name, fn):
        def call(x, *args, **kwargs):
            key = (name, tuple(x.shape))
            seen[key] = seen.get(key, 0) + 1
            return fn(x, *args, **kwargs)
        return call
    for name in FILTERED_ACT_ENTRIES:
        setattr(fa, name, counted(name, getattr(fa, name)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+", choices=PHASES)
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the serving protocol (default 50)")
    ap.add_argument("--vae_steps", type=int, default=8,
                    help="micro-steps of the VAE training path (default 8)")
    ap.add_argument("--sd_frames", type=int, default=17)
    ap.add_argument("--sd_steps", type=int, default=10)
    ap.add_argument("--video_frames", type=int, default=8)
    ap.add_argument("--video_steps", type=int, default=10)
    ap.add_argument("--normal_shifts", type=int, default=16)
    ap.add_argument("--trainer_steps", type=int, default=3)
    ap.add_argument("--bf16_interp_steps", type=int, default=20)
    ap.add_argument("--afp_steps", type=int, default=20)
    ap.add_argument("--afp_shifts", type=int, default=4)
    ap.add_argument("--afp_vae_steps", type=int, default=4)
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs of each phase in this process; the first "
                         "includes the cold start (default 1)")
    ap.add_argument("--shapes", action="store_true",
                    help="log the shapes each filtered-activation kernel "
                         "was called with in each run")
    args = ap.parse_args(argv)
    root = Path.cwd()
    if not (root / "chip_smoke.py").exists():
        print("phase_check: run from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))  # that checkout's package and chip_smoke
    import torch
    if not torch.cuda.is_available():
        print("phase_check: no CUDA device", file=sys.stderr)
        return 1
    smoke = importlib.import_module("chip_smoke")
    importlib.import_module("afldm_tpu_torch.kernels").build_all()
    importlib.import_module("afldm_tpu_torch.ops").set_af_precision("highest")
    seen = {}
    if args.shapes:
        count_shapes(importlib.import_module(
            "afldm_tpu_torch.ops.filtered_act"), seen)
    ok, sd_state = True, None
    for phase in [p for p in args.phases for _ in range(args.repeat)]:
        if phase == "main_path":
            good = smoke.run_main_path(torch, args.steps)[0]
        elif phase == "bf16_protocol":
            import numpy as np  # its PSNR deltas are against zeros here
            good, _ = smoke.run_bf16_protocol(torch, args.steps,
                                              np.zeros(16))
        elif phase == "af_precision":
            good, _ = smoke.run_af_precision_eval(torch, args.afp_steps,
                                                  args.afp_shifts)
        elif phase == "af_vae":
            good, _ = smoke.run_vae_training_level(torch, args.afp_vae_steps)
        elif phase == "bf16_interp":
            good, _ = smoke.run_bf16_interp(torch, args.bf16_interp_steps)
        elif phase == "vae_train":
            good, _ = smoke.run_vae_training(torch, args.vae_steps)
        elif phase == "sd_interp":
            good, _ = smoke.run_sd_interp(torch, args.sd_frames,
                                          args.sd_steps)
        elif phase == "video_edit":
            good, _ = smoke.run_video_editing(torch, args.video_frames,
                                              args.video_steps)
        elif phase == "normal":
            good, _ = smoke.run_normal_estimation(torch, args.normal_shifts)
        elif phase == "tiny_trainers":
            good = (smoke.check_tiny_new_trainers(torch)
                    & smoke.check_text_encoder(torch)
                    & smoke.check_sd_round_trip(torch))
        else:
            name = TRAINER_PHASES[phase]
            if name != "i2sb" and sd_state is None:
                sd_state = smoke._sd_states(torch)
            good, _ = smoke.run_new_trainer(torch, name, args.trainer_steps,
                                            sd_state)
        ok &= bool(good)
        for (name, shape), n in sorted(seen.items()):
            print(f"phase_check {phase} shapes: {name} {shape} x {n}",
                  flush=True)
        seen.clear()
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
