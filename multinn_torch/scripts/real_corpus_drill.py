"""One-command real-corpus drill — the port's counterpart of
``scripts/real_corpus_drill.py``: locate the real datasets, run the full
prepare -> train -> evaluate loop with the SHIPPED configs through
``multinn_torch.train`` and ``multinn_torch.evaluate``, and print the
measured quality next to the paper anchors.

    python -m multinn_torch.scripts.real_corpus_drill --data-root data \\
        [--corpus all] [--jsb path.pkl] [--nottingham path.pkl] \\
        [--lpd5 dir] [--lakh dir] [--synthetic-standin] [--device cuda] \\
        [extra --a.b=c overrides forwarded to train]

No real JSB Chorales / Nottingham / LPD-5 / Lakh data is in the
repository: this is the command to run once it is. It searches
``--data-root`` for the conventional file names, trains and evaluates each
corpus's shipped configs, and writes ``drill_report.json`` with the
paper-anchor comparison (Boulanger-Lewandowski et al. 2012, Table 1, for
JSB / Nottingham). ``--synthetic-standin`` generates corpus-format
stand-ins instead (the testable path; it certifies the pipeline, not the
quality). Runs on the CUDA card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from multinn_torch import evaluate as eval_cli
from multinn_torch import train as train_cli
from multinn_torch.scripts import prepare_dataset as prep

# search names per corpus, relative to --data-root (first hit wins)
_SEARCH = {
    "jsb": ("jsb.pkl", "jsb_chorales.pkl", "JSB Chorales.pickle",
            "jsb-chorales-16th.pkl"),
    "nottingham": ("nottingham.pkl", "Nottingham.pickle",
                   "nottingham-16th.pkl"),
    "lpd5": ("lpd5", "lpd_5", "lpd5_cleansed", "lpd_5_cleansed"),
    "lakh": ("lakh", "lmd", "lmd_full", "lmd_matched"),
}
# corpus -> list of (shipped config, run-dir suffix)
_CONFIGS = {
    "jsb": [("configs/jsb_rnnrbm.json", "jsb_rnnrbm")],
    "nottingham": [("configs/nottingham_rnnnade.json",
                    "nottingham_rnnnade")],
    "lpd5": [("configs/lpd5_feedback_rnnnade.json", "lpd5_feedback_rnnnade"),
             ("configs/lpd5_multinn_rnnrbm.json", "lpd5_multinn_rnnrbm")],
    "lakh": [("configs/lakh_16th_128bar.json", "lakh_128bar")],
}


def _find(corpus: str, root: str, explicit: str) -> str:
    if explicit:
        if not os.path.exists(explicit):
            # an explicit path must not silently become "no data" (or be
            # replaced by a synthetic stand-in): fail loudly
            raise SystemExit(f"--{corpus} {explicit!r} does not exist")
        return explicit
    for name in _SEARCH[corpus]:
        p = os.path.join(root, name)
        if os.path.exists(p):
            return p
    return ""


def _standin(corpus: str, root: str) -> str:
    """Generate the corpus-format stand-in (the testable path)."""
    os.makedirs(root, exist_ok=True)
    if corpus in ("jsb", "nottingham"):
        out = os.path.join(root, f"{corpus}_synth.pkl")
        rc = prep.main(["synthpickle", "--out", out, "--songs", "12"])
    else:
        out = os.path.join(root, f"{corpus}_synth")
        rc = prep.main(["synth", "--out", out, "--songs", "8"])
    if rc != 0:
        raise RuntimeError(f"stand-in generation failed for {corpus}")
    return out


def _mean(x):
    return round(float(np.mean(x)), 4) if len(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, allow_abbrev=False,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", default="all",
                    choices=("all",) + tuple(_CONFIGS))
    ap.add_argument("--data-root", default="data")
    for c in _CONFIGS:
        ap.add_argument(f"--{c}", default="",
                        help=f"explicit {c} data path (skips the search)")
    ap.add_argument("--run-root", default="runs")
    ap.add_argument("--synthetic-standin", action="store_true",
                    help="generate stand-ins instead of requiring real "
                         "data (pipeline certification, not quality)")
    ap.add_argument("--report", default="",
                    help="report path (default <run-root>/drill_report.json)")
    ap.add_argument("--device", default="cuda",
                    help="the device of train and evaluate (default cuda; "
                         "cpu for tests)")
    args, overrides = ap.parse_known_args(argv)

    corpora = list(_CONFIGS) if args.corpus == "all" else [args.corpus]
    report, missing = {}, []
    for corpus in corpora:
        path = _find(corpus, args.data_root, getattr(args, corpus))
        if not path and args.synthetic_standin:
            path = _standin(corpus, args.data_root)
        if not path:
            missing.append(corpus)
            print(f"[{corpus}] NO DATA — drop one of "
                  f"{list(_SEARCH[corpus])} into {args.data_root}/ (or pass "
                  f"--{corpus} <path>); skipping", file=sys.stderr)
            continue
        for cfg_path, name in _CONFIGS[corpus]:
            # stand-in runs get their own dirs, and a run dir trained on
            # DIFFERENT data must not be resumed (train resumes by default:
            # a stale synthetic checkpoint would report the stand-in
            # model's numbers as the real corpus')
            suffix = "_standin" if args.synthetic_standin else ""
            run_dir = os.path.join(args.run_root, f"drill_{name}{suffix}")
            prev_cfg = os.path.join(run_dir, "config.json")
            if os.path.exists(prev_cfg):
                with open(prev_cfg) as f:
                    prev_path = json.load(f).get("data", {}).get("path", "")
                if prev_path and prev_path != path:
                    raise SystemExit(
                        f"{run_dir} was trained on {prev_path!r}, not "
                        f"{path!r} — remove it or pass a fresh --run-root "
                        f"(resuming across data sources would report the "
                        f"old model's numbers for the new corpus)")
            print(f"[{corpus}] {cfg_path} <- {path}", file=sys.stderr)
            rc = train_cli.main(["--config", cfg_path, "--device",
                                 args.device, f"--data.path={path}",
                                 f"--train.run_dir={run_dir}"] + overrides)
            if rc != 0:
                print(f"[{corpus}] train failed rc={rc}", file=sys.stderr)
                return rc
            rc = eval_cli.main(["--run", run_dir, "--split", "test",
                                "--device", args.device])
            if rc != 0:
                print(f"[{corpus}] evaluate failed rc={rc}", file=sys.stderr)
                return rc
            with open(os.path.join(run_dir, "eval_test.json")) as f:
                ev = json.load(f)
            row = {"config": cfg_path, "data": path,
                   "ll_per_frame": ev["frame"].get("ll_per_frame"),
                   "paper_anchor": ev.get("paper_anchor"),
                   "synthetic_standin": bool(args.synthetic_standin)}
            gen = ev.get("musical_generated") or {}
            corp = ev.get("musical_corpus") or {}
            for k in ("note_density", "qualified_note_ratio"):
                if k in gen:
                    row[k] = {"generated": _mean(gen[k]),
                              "corpus": _mean(corp.get(k, []))}
            report[name + suffix] = row
            anchor = row["paper_anchor"] or {}
            ll = row["ll_per_frame"]
            ll_s = f"{ll:+.3f}" if ll is not None else "n/a (empty split)"
            print(f"[{corpus}] {name}: ll/frame {ll_s}"
                  + (f" vs 2012 anchor {anchor['test_ll_per_frame_2012']}"
                     if anchor else ""), file=sys.stderr)

    ran_any = bool(report)         # THIS invocation's rows, before the merge
    out = args.report or os.path.join(args.run_root, "drill_report.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    if os.path.exists(out):        # corpora land on different days: MERGE
        with open(out) as f:
            merged = json.load(f)
        merged.update(report)
        report = merged
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    print(f"wrote {out}", file=sys.stderr)
    if missing:
        print(f"corpora without data: {missing}", file=sys.stderr)
        return 3 if not ran_any else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
