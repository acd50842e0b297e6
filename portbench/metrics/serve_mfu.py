"""The whole generation step's share of the card's peak, in %: model FLOPs
of every frame of every song completed in the window over the window's
seconds and the f32 peak outside the tensor cores (the cells' precision)."""

from portbench import yardstick


def read(rec):
    if rec.get("kind") != "serve" or not rec["songs"]:
        return None
    flops = (yardstick.gen_frame_flops(rec["dims"], rec["decoder"],
                                       rec["gen_k"])
             * rec["n_steps"] * rec["songs"])
    return 100.0 * flops / (rec["window_s"] * yardstick.F32_FLOPS)
