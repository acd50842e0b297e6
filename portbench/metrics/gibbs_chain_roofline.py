"""The CD chain kernel's share of its roofline, in %: the least time its
launches inside the traced stretch could take (``yardstick.gibbs_cd1_work``
over one track's rows of one chip, B * T, at the batches' note density)
over their time in the traces of every chip."""

from portbench import yardstick


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or rec["decoder"] != "rnn-rbm" or not tr:
        return None
    if rec["cd_k"] != 1:
        return None
    count = secs = 0
    for name, (n, s) in tr["op_whole"].items():
        if "gibbs_" in name and "_kernel" in name:
            count, secs = count + n, secs + s
    if not count:
        return None
    n = rec["dims"]
    rows = rec["rows_per_launch"]
    least = yardstick.bound_s(*yardstick.gibbs_cd1_work(
        rows, rec["density"] * rows * n.d, n.d, n.h))
    return 100.0 * count * least / secs
