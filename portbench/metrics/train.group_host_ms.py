"""Median host time to stage a group of steps and enqueue its replay (the
benchmark's span around each ``Trainer.run_group`` call), in ms."""

import numpy as np


def read(rec):
    if rec.get("kind") != "train" or not rec["group_host_s"]:
        return None
    return float(np.median(rec["group_host_s"])) * 1e3
