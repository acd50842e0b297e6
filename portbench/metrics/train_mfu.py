"""The whole training step's share of the cards' peak, in %: model FLOPs
of every step run in the window (its global batch) over the window's
seconds and the f32 peak outside the tensor cores (the cells' precision:
f32, TF32 off) of every chip the cell uses."""

from portbench import yardstick


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    flops = (yardstick.train_step_flops(rec["dims"], rec["decoder"],
                                        rec["batch"], rec["window"],
                                        rec["cd_k"]) * rec["steps"])
    return 100.0 * flops / (rec["window_s"] * yardstick.F32_FLOPS
                            * rec["chips"])
