"""Training CLI: one JSON config with a ``base`` key and one trainer key
("vae", "ldm", "i2sb", "sd_text" or "norm_controlnet"). Runs on the card
unless given ``--device cpu``.

  python -m afldm_tpu_torch.scripts.train configs/vae/train_afvae_imagenet.json
  python -m afldm_tpu_torch.scripts.train configs/ldm/train_unet_ffhq.json
  python -m afldm_tpu_torch.scripts.train configs/sr/train_i2sb_imagenet.json
  python -m afldm_tpu_torch.scripts.train tiny.json --device cpu --max_steps 2

The SD trainers ("sd_text", "norm_controlnet") take their models from the
pipeline directory named by ``pretrained_model_name_or_path`` where it is
one; else SD text builds SD-1.5 widths with random weights, as the JAX
package does.

The loop of the JAX package's ``train.py``: shuffled epochs, window-mean
metrics as JSON lines every 10 steps (``<output_dir>/<logging_dir>/
metrics.jsonl``), ``checkpoint-{step}`` every ``checkpointing_steps`` with
rotation, resume from ``resume_from_checkpoint`` ("latest" or a path),
validation every ``valid_steps`` and at the epoch cadence, and
``save_pipeline`` at the save cadence and at the end.
"""

import argparse
import json
import logging
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop after this many steps (smoke runs)")
    p.add_argument("--max_minutes", type=float, default=None,
                   help="wall-clock budget; stops cleanly (checkpoint and "
                        "pipeline saved) once it has elapsed")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    from ..train import (create_trainer, epoch_batches, latest_checkpoint,
                         load_training_config, make_dataset,
                         restore_checkpoint, resume_step_from_path,
                         save_checkpoint)
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        force=True)
    log = logging.getLogger("train")

    cfgs = load_training_config(args.config)
    base = cfgs["base"]
    key = next(k for k in cfgs if k != "base")
    cfg = cfgs[key]
    os.makedirs(os.path.join(base.output_dir, base.logging_dir),
                exist_ok=True)

    trainer = create_trainer(key, base, cfg, device=args.device)
    log.info("device: %s", trainer.device)
    trainer.init_modules()
    dataset = make_dataset(base)
    trainer.set_dataset(dataset)
    steps_per_epoch = len(dataset) // base.train_batch_size
    trainer.init_optimizers(steps_per_epoch * base.num_epochs)
    trainer.prepare_modules(seed=base.seed or 0)

    global_step = 0
    if base.resume_from_checkpoint:
        path = (latest_checkpoint(base.output_dir)
                if base.resume_from_checkpoint == "latest"
                else base.resume_from_checkpoint)
        if path:
            log.info("resuming from %s", path)
            trainer.load_state(restore_checkpoint(path, trainer.device))
            global_step = resume_step_from_path(path)

    def checkpoint():
        save_checkpoint(base.output_dir, global_step,
                        trainer.state_for_checkpoint(),
                        total_limit=base.checkpoints_total_limit)

    metrics = open(os.path.join(base.output_dir, base.logging_dir,
                                "metrics.jsonl"), "a")
    sums, counts = {}, {}
    t0 = time.time()
    done = False
    log.info("training %s: %d steps/epoch, %d epochs", key, steps_per_epoch,
             base.num_epochs)
    try:
        for epoch in range(base.num_epochs):
            if done:
                break
            for batch in epoch_batches(dataset, base.train_batch_size,
                                       seed=(base.seed or 0) + epoch):
                if args.max_steps and global_step >= args.max_steps:
                    done = True
                    break
                logs = trainer.training_step(global_step, batch)
                for k, v in logs.items():
                    sums[k] = sums.get(k, 0.0) + v
                    counts[k] = counts.get(k, 0) + 1
                global_step += 1
                if global_step % 10 == 0:
                    row = {k: sums[k] / counts[k] for k in sums}
                    sums, counts = {}, {}
                    row["step"] = global_step
                    row["steps_per_s"] = global_step / (time.time() - t0)
                    metrics.write(json.dumps(row) + "\n")
                    metrics.flush()
                    log.info("step %d %s", global_step, row)
                if global_step % base.checkpointing_steps == 0:
                    checkpoint()
                    log.info("wrote checkpoint-%d", global_step)
                if base.valid_steps and global_step % base.valid_steps == 0:
                    trainer.validate(global_step)
                    log.info("validation @%d", global_step)
                if args.max_steps and global_step >= args.max_steps:
                    done = True
                    break
                if (args.max_minutes
                        and time.time() - t0 > args.max_minutes * 60):
                    log.info("wall-clock budget (%.1f min) reached at step "
                             "%d", args.max_minutes, global_step)
                    done = True
                    break
            if base.valid_epochs and ((epoch + 1) % base.valid_epochs == 0
                                      or epoch == base.num_epochs - 1):
                trainer.validate(global_step)
                log.info("validation (epoch %d)", epoch)
            if (base.save_model_epochs
                    and (epoch + 1) % base.save_model_epochs == 0) or done:
                trainer.save_pipeline(os.path.join(base.output_dir,
                                                   "pipeline"))
                log.info("saved pipeline (epoch %d)", epoch)
    finally:
        metrics.close()
    checkpoint()
    trainer.save_pipeline(os.path.join(base.output_dir, "pipeline"))
    log.info("done at step %d", global_step)
    return global_step


if __name__ == "__main__":
    main()
