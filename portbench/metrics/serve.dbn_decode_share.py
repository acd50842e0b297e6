"""The DBN decode's share of the card time of the batches served in the
window, in %: the program's ``gen.dbn_decode`` card intervals over its
``serve.card`` ones, summed over the batches whose ``serve.take`` ended
inside the window (``--trace 1`` runs, with the program's span recorder
on). Nothing where the program records no such span."""


def read(rec):
    spans = rec.get("spans")
    if rec.get("kind") != "serve" or not spans:
        return None
    t0, t1 = rec["window_ns"]
    batches = {i for name, _, end, i in spans
               if name == "serve.take" and t0 <= end <= t1}
    time_of = lambda what: sum(end - start for name, start, end, i in spans
                               if name == what and i in batches)
    card, decode = time_of("serve.card"), time_of("gen.dbn_decode")
    if not card or not decode:
        return None
    return 100.0 * decode / card
