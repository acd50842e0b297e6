"""Dataset preparation — the port's counterpart of
``scripts/prepare_dataset.py``, on ``multinn_torch.data`` and
``multinn_torch.eval.musical``, with the same subcommands, flags and
outputs (host only: nothing here touches a device).

Subcommands:
  cache  — parse a corpus (midi_dir / pickle / synthetic) once and write a
           windowed-roll ``.npz`` cache that ``--data.source=npz`` loads fast:
             python -m multinn_torch.scripts.prepare_dataset cache \\
                 --preset lpd5 --source midi_dir --path data/lpd5 \\
                 --out data/lpd5_rolls.npz
  cachedir — STREAM a corpus into a memory-mapped window-cache DIRECTORY
           (data/cache.py; O(one song) peak memory at any corpus size — the
           out-of-core prep for full Lakh, where windows exceed host RAM):
             python -m multinn_torch.scripts.prepare_dataset cachedir \\
                 --preset lakh --source midi_dir --path data/lakh \\
                 --out data/lakh_cache
             python -m multinn_torch.train \\
                 --config configs/lakh_16th_128bar.json \\
                 --data.source=cache_dir --data.path=data/lakh_cache
  synth  — render the synthetic corpus to .mid files (the first-party MIDI
           writer end to end):
             python -m multinn_torch.scripts.prepare_dataset synth \\
                 --out data/synth --songs 8
  synthpickle — write a corpus-format Boulanger-Lewandowski pickle from the
           synthetic generator
  stats  — print corpus statistics (rolls, windows, density, musical
           metrics):
             python -m multinn_torch.scripts.prepare_dataset stats \\
                 --preset jsb --source pickle --path data/jsb.pkl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys

import numpy as np

from multinn_torch.data import cache as cache_mod
from multinn_torch.data import midi as midi_mod
from multinn_torch.data import pianoroll as pr
from multinn_torch.data.datasets import Dataset, synthetic_corpus
from multinn_torch.eval import musical
from multinn_torch.utils.config import DataConfig


def add_data_args(p):
    p.add_argument("--preset", default="synthetic")
    p.add_argument("--source", default=None,
                   help="synthetic | midi_dir | npz | pickle "
                        "(default: preset's)")
    p.add_argument("--path", default="")
    p.add_argument("--window", type=int, default=None)
    p.add_argument("--songs", type=int, default=16,
                   help="synthetic corpus size")


def make_cfg(args) -> DataConfig:
    kw = dict(synthetic_songs=args.songs)
    if args.source:
        kw["source"] = args.source
    if args.path:
        kw["path"] = args.path
    if args.window:
        kw["window"] = args.window
    return DataConfig.from_preset(args.preset, **kw)


def cmd_cache(args) -> int:
    ds = Dataset(make_cfg(args))
    # per-split keys: reloading with source=npz keeps the original
    # train/valid/test assignment (a flat array would be re-split at
    # random, leaking test windows into train)
    arrays = {f"rolls_{s}": ds.windows[s] for s in ("train", "valid", "test")}
    np.savez_compressed(args.out, **arrays)
    total = sum(len(a) for a in arrays.values())
    print(f"wrote {args.out}: {total} windows "
          + " ".join(f"{s}={len(a)}" for s, a in arrays.items())
          + f" ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return 0


def cmd_cachedir(args) -> int:
    cfg = make_cfg(args)
    if cfg.source == "midi_dir":
        counts = cache_mod.write_cache(args.out, cfg,
                                       cache_mod.iter_midi_dir(cfg))
    elif cfg.source == "synthetic":
        counts = cache_mod.write_cache(args.out, cfg,
                                       cache_mod.iter_synthetic(cfg))
    else:
        # pickle / npz corpora are small: build in memory and dump exactly
        # (keeps the pickle's own split)
        counts = cache_mod.write_cache_from_dataset(Dataset(cfg), args.out)
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    print(f"wrote window cache {args.out}: "
          + " ".join(f"{s}={n}" for s, n in sorted(counts.items()))
          + f" ({size / 1e6:.1f} MB; load with --data.source=cache_dir)")
    return 0


def cmd_synth(args) -> int:
    cfg = make_cfg(args)
    os.makedirs(args.out, exist_ok=True)
    for i, roll in enumerate(synthetic_corpus(cfg)):
        mid = pr.roll_to_midi(roll, cfg.spec())
        midi_mod.save(mid, os.path.join(args.out, f"synth_{i:04d}.mid"))
    print(f"wrote {cfg.synthetic_songs} MIDI files to {args.out}")
    return 0


def cmd_synthpickle(args) -> int:
    """Write a corpus-FORMAT-faithful Boulanger-Lewandowski pickle from the
    synthetic generator: {'train'|'valid'|'test': [sequence]} with each
    sequence a list of TUPLES OF ACTIVE MIDI PITCHES per step — the
    structure the public JSB / Nottingham pickles use, so the pickle ingest
    path (load_pickle -> split handling -> windows) runs end to end before
    the real corpora are in place.

        python -m multinn_torch.scripts.prepare_dataset synthpickle \\
            --out data/jsb_synth.pkl
        python -m multinn_torch.train --config configs/jsb_rnnrbm.json \\
            --data.path=data/jsb_synth.pkl
    """
    # chorale-like: one track, the canonical 88-key range, varied lengths
    cfg = dataclasses.replace(make_cfg(args), n_tracks=1, pitch_min=21,
                              pitch_max=108)
    rolls = synthetic_corpus(cfg)
    rng = np.random.default_rng(cfg.seed)

    def to_tuples(roll):
        length = int(rng.integers(roll.shape[0] // 2, roll.shape[0] + 1))
        return [tuple(int(p) + cfg.pitch_min
                      for p in np.flatnonzero(roll[t, 0]))
                for t in range(length)]

    n = len(rolls)
    n_tr, n_va = int(0.8 * n), int(0.1 * n)
    corpus = {
        "train": [to_tuples(r) for r in rolls[:n_tr]],
        "valid": [to_tuples(r) for r in rolls[n_tr:n_tr + n_va]],
        "test": [to_tuples(r) for r in rolls[n_tr + n_va:]],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(corpus, f)
    print(f"wrote {args.out}: "
          + " ".join(f"{s}={len(v)} sequences" for s, v in corpus.items()))
    return 0


def cmd_stats(args) -> int:
    cfg = make_cfg(args)
    ds = Dataset(cfg)
    out = {}
    for split, w in ds.windows.items():
        out[split] = {"windows": int(len(w)), "shape": list(w.shape[1:]),
                      "density": float(w.mean())}
    corpus = ds.windows["train"][:64]
    out["musical_train"] = musical.evaluate_rolls(
        corpus, steps_per_bar=cfg.steps_per_quarter * 4,
        pitch_min=cfg.pitch_min,
        drum_track=0 if cfg.n_tracks == 5 else None)
    print(json.dumps(out, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("cache", cmd_cache), ("cachedir", cmd_cachedir),
                     ("synth", cmd_synth),
                     ("synthpickle", cmd_synthpickle), ("stats", cmd_stats)):
        sp = sub.add_parser(name)
        add_data_args(sp)
        if name in ("cache", "cachedir", "synth", "synthpickle"):
            sp.add_argument("--out", required=True)
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
