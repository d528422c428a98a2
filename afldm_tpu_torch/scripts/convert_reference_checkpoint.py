"""Turn a diffusers pipeline directory into the pipeline directory that
``pipelines.loading.load_sd_components`` and ``load_pipeline`` read:

    unet/config.json + diffusion_pytorch_model.{safetensors,bin}
    vae/...                    (the alias-free keys ride in the config)
    controlnet/...             (normal estimation)
    scheduler/scheduler_config.json
    text_encoder/ + tokenizer/ (SD-based pipelines)

become ``unet_config.json``, ``vae_config.json``, ``controlnet_config.json``,
``scheduler_config.json``, the copied ``text_encoder/`` and ``tokenizer/``,
``checkpoint-0`` (unet, an empty unet_ema, vae, controlnet) and
``provenance.json``. The weights carry diffusers keys already, so each
component is a strict load into this package's module and a save, with no
renaming. ``.bin`` files are read with ``torch.load(weights_only=True)``,
``.safetensors`` with the ``safetensors`` package where it is installed.

    python -m afldm_tpu_torch.scripts.convert_reference_checkpoint SRC OUT

Any unmatched, missing or misshapen key (or a text encoder that does not
load) makes the script exit non-zero; ``--lenient`` writes the directory
anyway, with those keys left at random weights, and warns.
"""

import argparse
import json
import os
import shutil

WEIGHT_FILES = ("diffusion_pytorch_model.safetensors",
                "diffusion_pytorch_model.bin",
                "model.safetensors", "pytorch_model.bin")


def _module(kind, cfg, alias_free):
    from ..models import (AutoencoderKL, AutoencoderKLConfig,
                          ControlNetConfig, ControlNetModel,
                          UNet2DConditionConfig, UNet2DConditionModel,
                          UNet2DConfig, UNet2DModel)
    if kind == "vae":
        return AutoencoderKL(AutoencoderKLConfig.from_diffusers(
            cfg, alias_free=alias_free))
    if kind == "controlnet":
        return ControlNetModel(ControlNetConfig.from_diffusers(
            cfg, alias_free=alias_free))
    if "cross_attention_dim" in cfg:
        return UNet2DConditionModel(UNet2DConditionConfig.from_diffusers(
            cfg, alias_free=alias_free))
    return UNet2DModel(UNet2DConfig.from_diffusers(cfg,
                                                   alias_free=alias_free))


def convert_component(subdir, kind, alias_free):
    """(config dict, state dict of the module, problems): the module of
    ``kind`` built from ``subdir/config.json`` and given every weight of
    the same key and shape; problems name the keys that did not match."""
    from ..models.text_encoder import read_state_dict
    with open(os.path.join(subdir, "config.json")) as f:
        cfg = {k: v for k, v in json.load(f).items()
               if not k.startswith("_")}
    module = _module(kind, cfg, alias_free)
    want = module.state_dict()
    got = read_state_dict(subdir, WEIGHT_FILES)
    shapes = [k for k in got if k in want
              and tuple(got[k].shape) != tuple(want[k].shape)]
    problems = [(kind, "unmatched keys", sorted(set(got) - set(want))),
                (kind, "missing keys", sorted(set(want) - set(got))),
                (kind, "misshapen keys", sorted(shapes))]
    module.load_state_dict({k: v for k, v in got.items()
                            if k in want and k not in shapes}, strict=False)
    return (dict(cfg, alias_free=alias_free), module.state_dict(),
            [p for p in problems if p[2]])


def convert_pipeline_dir(src, out, alias_free=True, lenient=False,
                         log=print):
    from ..models.text_encoder import load_clip_text_model
    from ..train.checkpoint import save_checkpoint
    os.makedirs(out, exist_ok=True)
    state, problems = {}, []
    for kind in ("unet", "vae", "controlnet"):
        subdir = os.path.join(src, kind)
        if not os.path.isdir(subdir):
            continue
        cfg, weights, bad = convert_component(subdir, kind, alias_free)
        problems += bad
        with open(os.path.join(out, f"{kind}_config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        state[kind] = weights
        log(f"{kind}/: {len(weights)} tensors, "
            f"{sum(len(p[2]) for p in bad)} keys unmatched")
    if "unet" not in state or "vae" not in state:
        raise SystemExit(f"{src}: expected at least unet/ and vae/ "
                         f"subfolders, found {sorted(os.listdir(src))}")

    sched = os.path.join(src, "scheduler", "scheduler_config.json")
    if os.path.exists(sched):
        with open(sched) as f:
            s = {k: v for k, v in json.load(f).items()
                 if not k.startswith("_")}
        with open(os.path.join(out, "scheduler_config.json"), "w") as f:
            json.dump(s, f, indent=2)
    for aux in ("text_encoder", "tokenizer"):
        sub = os.path.join(src, aux)
        if not os.path.isdir(sub):
            continue
        if aux == "text_encoder":
            try:
                load_clip_text_model(sub)
            except (OSError, RuntimeError, ImportError, KeyError) as e:
                problems.append((aux, "does not load", [str(e)]))
        dst = os.path.join(out, aux)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(sub, dst)
        log(f"copied {aux}/")

    for kind, what, keys in problems:
        log(f"PROBLEM {kind}: {what}: {keys[:10]}")
    if problems and not lenient:
        raise SystemExit("conversion not clean (pass --lenient to write "
                         "anyway)")
    ckpt = {"unet": state["unet"], "unet_ema": {}, "vae": state["vae"]}
    if "controlnet" in state:
        ckpt["controlnet"] = state["controlnet"]
    save_checkpoint(out, 0, ckpt)
    with open(os.path.join(out, "provenance.json"), "w") as f:
        json.dump({"provenance": "converted",
                   "source": os.path.abspath(src)}, f, indent=2)
    log(f"wrote {out} (checkpoint-0)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="diffusers pipeline directory (unet/, vae/, "
                               "scheduler/, ...)")
    p.add_argument("out", help="output pipeline directory")
    p.add_argument("--no_alias_free", dest="alias_free",
                   action="store_false",
                   help="build the plain models (alias-free is the "
                        "default, as the reference applies its alias-free "
                        "surgery after loading)")
    p.add_argument("--lenient", action="store_true",
                   help="write the directory despite unmatched keys")
    args = p.parse_args(argv)
    return convert_pipeline_dir(args.src, args.out,
                                alias_free=args.alias_free,
                                lenient=args.lenient)


if __name__ == "__main__":
    main()
