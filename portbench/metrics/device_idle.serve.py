"""Share of the traced serving window in which no operation ran on the
card, in %: one minus the union of the operations' intervals."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
