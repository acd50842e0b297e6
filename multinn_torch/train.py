"""Training entry point of the port — counterpart of the repo's ``train.py``.

    python -m multinn_torch.train --config CONFIG.json [--a.b.c=value ...]
    python -m multinn_torch.train --preset jsb --data.path=PICKLE
    python -m multinn_torch.train --config CONFIG.json --device cpu

Builds the dataset, the model and the ``Trainer`` from the JSON config (or
a dataset preset) and the dot-path overrides, saves ``config.json`` into
the run dir, resumes from the run dir's latest checkpoint unless
``--no-resume``, trains and logs the final validation metrics. Runs on the
CUDA card unless ``--device`` names another.

With ``--mesh.use_mesh=true`` each rank runs this entry point, as a
launcher such as ``torchrun --nproc_per_node=N -m multinn_torch.train``
starts them: a rank that has not joined a world joins it from the env://
variables the launcher sets (parallel/mesh.init_distributed), and rank 0
writes the run's files.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    p.add_argument("--config", help="path to an ExperimentConfig JSON")
    p.add_argument("--preset", help="dataset preset (synthetic/jsb/...) when "
                                    "no --config is given")
    p.add_argument("--no-resume", action="store_true",
                   help="do not resume from run_dir checkpoints")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="write a torch.profiler trace of N train steps into "
                        "<run_dir>/trace before training")
    p.add_argument("--device", default="cuda",
                   help="the training device (default cuda; cpu for tests)")
    return p.parse_known_args(argv)


def build_config(args, overrides):
    from multinn_torch.models.multinn import MultINNConfig
    from multinn_torch.utils import config as cfg_mod
    if args.config:
        cfg = cfg_mod.load_json(args.config)
    else:
        data = cfg_mod.DataConfig.from_preset(args.preset or "synthetic")
        model = MultINNConfig(n_tracks=data.n_tracks,
                              n_pitches=data.frame_dim)
        cfg = cfg_mod.ExperimentConfig(name=args.preset or "synthetic",
                                       data=data, model=model)
    if overrides:
        cfg = cfg_mod.apply_overrides(cfg, overrides)
        # preset path: the model's visible width follows the data config
        # unless model.n_pitches was pinned
        if (not args.config
                and not any(o.lstrip("-").startswith("model.n_pitches=")
                            for o in overrides)
                and cfg.model.n_pitches != cfg.data.frame_dim):
            cfg = cfg_mod.apply_overrides(
                cfg, [f"model.n_pitches={cfg.data.frame_dim}"])
    return cfg.validate()


def main(argv=None) -> int:
    args, overrides = parse_args(argv)
    cfg = build_config(args, overrides)

    import torch.distributed as dist

    from multinn_torch.training.trainer import Trainer
    from multinn_torch.utils import config as cfg_mod

    if cfg.mesh.use_mesh and not dist.is_initialized():
        from multinn_torch.parallel.mesh import init_distributed
        init_distributed()
    os.makedirs(cfg.train.run_dir, exist_ok=True)
    if not dist.is_initialized() or dist.get_rank() == 0:
        cfg_mod.save_json(cfg, os.path.join(cfg.train.run_dir,
                                            "config.json"))
    trainer = Trainer(cfg, device=args.device)
    if not args.no_resume:
        trainer.maybe_resume()
    if args.profile_steps:
        trainer.profile_steps(args.profile_steps)
    final = trainer.train()
    trainer.log.info("done: %s", {k: round(v, 4) for k, v in final.items()
                                  if isinstance(v, float)})
    trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
