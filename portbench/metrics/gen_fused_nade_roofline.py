"""The whole-generation RNN-NADE kernel's share of its roofline, in %: the
least time its launches inside the traced window could take
(``yardstick.fused_work`` at the served rolls' note density) over their
time in the trace."""

from portbench import yardstick

KERNEL = "gen_fused_nade_kernel"
DECODER = "rnn-nade"


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or rec["decoder"] != DECODER or not tr:
        return None
    count = secs = 0
    for name, (n, s) in tr["op_whole"].items():
        if KERNEL in name:
            count, secs = count + n, secs + s
    if not count or not rec["density"]:
        return None
    n = rec["dims"]
    nnz = rec["density"] * rec["batch"] * rec["n_steps"] * n.k * n.d
    least = yardstick.bound_s(*yardstick.fused_work(
        n, DECODER, rec["batch"], rec["n_steps"], nnz, rec["gen_k"]))
    return 100.0 * count * least / secs
