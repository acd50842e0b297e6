"""Share of the traced stretch of training in which no operation ran on the
card, in %: one minus the union of the operations' intervals; the highest
over the chips."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("idle_by_rank"):
        return None
    return 100.0 * max(rec["idle_by_rank"])
