"""Evaluation entry point of the port — counterpart of the repo's
``evaluate.py``.

    python -m multinn_torch.evaluate --run RUN_DIR [--split test] [--no-musical]
    python -m multinn_torch.evaluate --run RUN_DIR --device cpu

Restores the checkpoint (best by default, latest with --latest), computes
the split's losses, frame metrics and log-likelihood per frame
(``Trainer.evaluate``), then generates ``--n-gen`` songs under
``PRNGKey(train.seed + 99)`` primed on the split's windows and reports
their musical statistics beside the training corpus' and a Welch
significance summary. Writes ``<run_dir>/eval_<split>.json`` and prints
it. Runs on the CUDA card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Boulanger-Lewandowski et al. 2012, Table 1 (arXiv:1206.6392): test
# log-likelihood per frame, reported beside the measured one. The RBM
# number is a pseudo-log-likelihood proxy; the NADE number is exact.
_ANCHORS = {("jsb", "rnn-rbm"): -6.27, ("jsb", "rnn-nade"): -5.56,
            ("nottingham", "rnn-rbm"): -2.39,
            ("nottingham", "rnn-nade"): -2.31}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    p.add_argument("--run", help="run dir (config.json + ckpt/)")
    p.add_argument("--config", help="explicit config JSON")
    p.add_argument("--split", default="test")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--latest", action="store_true")
    p.add_argument("--no-musical", action="store_true",
                   help="skip generation + musical metrics")
    p.add_argument("--n-gen", type=int, default=32,
                   help="samples for musical metrics (>=32 keeps the Welch "
                        "significance block meaningful)")
    p.add_argument("--device", default="cuda",
                   help="the evaluation device (default cuda; cpu for tests)")
    return p.parse_known_args(argv)


def main(argv=None) -> int:
    args, overrides = parse_args(argv)
    from multinn_torch.utils import config as cfg_mod
    try:
        cfg = cfg_mod.on_one_device(cfg_mod.load_run_config(
            args.run, args.config, overrides))
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2

    from multinn_torch.data.datasets import Dataset
    from multinn_torch.eval import musical
    from multinn_torch.ops import sampling
    from multinn_torch.training.generator import Generator
    from multinn_torch.training.trainer import Trainer

    dataset = Dataset(cfg.data)
    trainer = Trainer(cfg, dataset=dataset, device=args.device)
    step = args.step
    if step is None and not args.latest:
        step = trainer.ckpt.best_step()
    trainer.restore(step=step)

    report = {"run": cfg.train.run_dir, "step": trainer.step,
              "split": args.split, "encoding": cfg.data.encoding}
    report["frame"] = {k: float(v) for k, v in
                       trainer.evaluate(args.split).items()}

    anchor = _ANCHORS.get((cfg.data.dataset, cfg.model.decoder_type))
    if anchor is not None:
        report["paper_anchor"] = {
            "test_ll_per_frame_2012": anchor,
            "measured_ll_per_frame": report["frame"].get("ll_per_frame"),
            "measured_is_exact_ll": cfg.model.decoder_type == "rnn-nade",
            # onset/hold LL is over the 2D-channel representation — a
            # different sample space than the anchors' frame rolls
            "comparable_representation": cfg.data.encoding == "frame",
            "synthetic_stand_in": "synth" in (cfg.data.path or "").lower(),
            "source": "arXiv:1206.6392 Table 1 (see PAPERS.md caveat)",
        }

    if not args.no_musical:
        steps_per_bar = cfg.data.steps_per_quarter * 4
        drum_track = 0 if cfg.model.n_tracks == 5 else None
        gen = Generator(cfg, trainer.params)
        seed = dataset.seed_windows(args.split, n=args.n_gen)
        seed = seed[:, :cfg.generate.seed_steps]
        rolls = gen.generate(
            sampling.PRNGKey(cfg.train.seed + 99, device=gen.device),
            cfg.generate.n_steps, seed=seed)
        # the metrics run in frame space: generated rolls are finalized,
        # the corpus is decoded only (no post-processing of real data)
        rolls = gen.finalize(rolls)
        corpus = dataset.decode(
            dataset.windows["train"][:max(args.n_gen * 4, 32)])
        report["musical_generated"] = musical.evaluate_rolls(
            rolls, steps_per_bar, cfg.data.pitch_min, drum_track)
        report["musical_corpus"] = musical.evaluate_rolls(
            corpus, steps_per_bar, cfg.data.pitch_min, drum_track)
        report["musical_significance"] = musical.compare_rolls(
            rolls, corpus, steps_per_bar, cfg.data.pitch_min, drum_track)

    out = os.path.join(cfg.train.run_dir, f"eval_{args.split}.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"\nwrote {out}", file=sys.stderr)
    trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
