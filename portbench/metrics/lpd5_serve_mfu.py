"""The whole generation step's share of the card's peak for the per-track
DBN model, in %: model FLOPs of every frame of every song completed in
the window (``yardstick_per_track.gen_frame_flops``: the LSTM, the
conditioned biases, the Gibbs sweeps and the DBN decode) over the
window's seconds and the f32 peak outside the tensor cores (the cell's
precision)."""

from portbench import yardstick_per_track


def read(rec):
    if (rec.get("kind") != "serve" or rec.get("mode") != "per-track"
            or not rec["songs"]):
        return None
    flops = (yardstick_per_track.gen_frame_flops(rec["dims"], rec["gen_k"])
             * rec["n_steps"] * rec["songs"])
    return 100.0 * flops / (rec["window_s"] * yardstick_per_track.F32_FLOPS)
