"""Rows that carried a request over rows dispatched in the window, in %:
the service's ``batches`` and ``padded_rows`` counters read before and
after it."""


def read(rec):
    if rec.get("kind") != "serve" or not rec["batches"]:
        return None
    rows = rec["batches"] * rec["batch"]
    return 100.0 * (rows - rec["padded_rows"]) / rows
