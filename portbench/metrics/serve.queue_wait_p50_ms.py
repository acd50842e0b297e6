"""Median wait of the window's requests in the service's queue, enqueue to
dispatch (``ServeResult.queue_s``), in ms."""

import numpy as np


def read(rec):
    if rec.get("kind") != "serve" or not rec["queue_s"]:
        return None
    return float(np.median(rec["queue_s"])) * 1e3
