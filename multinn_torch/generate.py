"""Generation entry point of the port — counterpart of the repo's
``generate.py``.

    python -m multinn_torch.generate --run RUN_DIR [--generate.n_steps=1024 ...]
    python -m multinn_torch.generate --config CONFIG.json --step 1200
    python -m multinn_torch.generate --run RUN_DIR --device cpu

Restores the checkpoint (best by default, latest with --latest), primes on
validation seed windows, samples under ``PRNGKey(train.seed + 7)`` and
writes the MIDI files, a pianoroll PNG each and ``pianorolls.npz`` (key
``rolls``, the finalized frame rolls) into ``<run_dir>/<generate.out_dir>``.
Runs on the CUDA card unless ``--device`` names another.

Accompaniment: fix some tracks to given music and sample the rest:

    python -m multinn_torch.generate --run RUN_DIR --accompany melody.mid \\
        --accompany-tracks 1,3

``--accompany`` takes a .mid/.midi file (quantized through the run's grid
and track spec) or an .npz whose key ``roll`` holds a frame-space (T, K, D)
or (B, T, K, D) pianoroll; only the --accompany-tracks slices are read.
"""

from __future__ import annotations

import argparse
import os
import sys
import zipfile

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--run", help="run dir (reads its config.json + ckpt/)")
    p.add_argument("--config", help="explicit config JSON (alternative)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: best, else latest)")
    p.add_argument("--latest", action="store_true",
                   help="use latest instead of best checkpoint")
    p.add_argument("--no-seed", action="store_true",
                   help="generate from scratch (no priming)")
    p.add_argument("--accompany", default=None,
                   help="given music whose --accompany-tracks slices are "
                        "fixed (the other tracks are sampled): a .mid/"
                        ".midi file (quantized via the run's data spec) or "
                        "an npz (key 'roll') with a FRAME-space (T, K, D) "
                        "or (B, T, K, D) pianoroll")
    p.add_argument("--accompany-tracks", default="",
                   help="comma-separated track indices fixed to --accompany")
    p.add_argument("--device", default="cuda",
                   help="the generation device (default cuda; cpu for tests)")
    return p.parse_known_args(argv)


def _given_roll(path: str, cfg):
    """The frame-space (B, T, K, D) roll of ``--accompany``, or an error
    message."""
    if path.lower().endswith((".mid", ".midi")):
        from multinn_torch.data.datasets import parse_midi_file
        given = parse_midi_file(path, cfg.data.spec(), use_native=False)
        if given is None:
            return None, f"--accompany: {path} is not parseable MIDI"
        return given[None], None
    try:
        given = np.load(path)["roll"]
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None, (f"--accompany: {path} must be a .mid/.midi file or "
                      "an .npz with a 'roll' array (B, T, K, D)")
    return (given[None] if given.ndim == 3 else given), None


def main(argv=None) -> int:
    args, overrides = parse_args(argv)
    from multinn_torch.utils import config as cfg_mod
    try:
        cfg = cfg_mod.on_one_device(cfg_mod.load_run_config(
            args.run, args.config, overrides))
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2

    from multinn_torch.data import pianoroll as pr
    from multinn_torch.data.datasets import Dataset
    from multinn_torch.ops import sampling
    from multinn_torch.training.generator import Generator
    from multinn_torch.training.trainer import Trainer

    dataset = Dataset(cfg.data)
    trainer = Trainer(cfg, dataset=dataset, device=args.device)
    step = args.step
    if step is None and not args.latest:
        step = trainer.ckpt.best_step()
    trainer.restore(step=step)

    gen = Generator(cfg, trainer.params)
    gcfg = cfg.generate
    seed = None
    if not args.no_seed and gcfg.seed_steps > 0:
        seed = dataset.seed_windows("valid", n=gcfg.n_samples)
        seed = seed[:, :gcfg.seed_steps]
    key = sampling.PRNGKey(cfg.train.seed + 7, device=gen.device)
    out_dir = os.path.join(cfg.train.run_dir, gcfg.out_dir)
    if args.accompany:
        tracks = tuple(int(t) for t in args.accompany_tracks.split(",")
                       if t.strip() != "")
        if not tracks:
            print("--accompany needs --accompany-tracks", file=sys.stderr)
            return 2
        given, err = _given_roll(args.accompany, cfg)
        if err:
            print(err, file=sys.stderr)
            return 2
        if gcfg.n_steps and given.shape[1] > gcfg.n_steps:
            given = given[:, :gcfg.n_steps]   # the length knob, both formats
        if not np.any(given[:, :, list(tracks)]):
            # quantization maps every instrument to track 0 unless the model
            # has 5 tracks (the LPD-5 program mapping)
            print(f"warning: --accompany-tracks {tracks} are all-silent "
                  "in the given roll — accompaniment will condition on "
                  "silence (MIDI track mapping collapses to track 0 "
                  "unless the model has 5 tracks)", file=sys.stderr)
        # binarize before any encoding, as the service's requests are
        given = (np.asarray(given) > 0).astype(np.uint8)
        if cfg.data.encoding == "onset_hold":    # frame -> model space
            given = np.stack([pr.encode_onset_hold(g) for g in given])
        if seed is not None:                     # match the given batch
            reps = -(-given.shape[0] // seed.shape[0])
            seed = np.concatenate([seed] * reps)[:given.shape[0]]
        rolls = gen.finalize(gen.accompany(key, given, tracks, seed=seed))
        paths = gen.write_files(rolls, out_dir, prefix="accompany",
                                bpm=gcfg.bpm)
    else:
        rolls, paths = gen.generate_to_files(
            key, out_dir, n_samples=gcfg.n_samples, n_steps=gcfg.n_steps,
            seed=seed, bpm=gcfg.bpm)
    np.savez_compressed(os.path.join(out_dir, "pianorolls.npz"),
                        rolls=rolls)
    print(f"wrote {len(paths)} MIDI files to {out_dir} "
          f"(pianoroll shape {rolls.shape}, density {rolls.mean():.4f})")
    trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
