"""Parallelism layer — port of multinn_tpu/parallel: a process mesh with
axes ``(data, track, model, seq)`` on ``torch.distributed`` (mesh.py), the
collectives the JAX package leaves to XLA (comm.py) and the time-axis
microbatch pipeline (seqpipe.py). One process per rank runs explicit
per-rank code; ``mesh.style`` picks the global-view semantics (gspmd) or
per-shard ones (shard_map, seqpipe).

The names below resolve on first use: the models import ``comm`` while
``mesh`` imports the config, which imports the models."""

_EXPORTS = {
    "MeshConfig": "multinn_torch.parallel.mesh",
    "Mesh": "multinn_torch.parallel.mesh",
    "make_mesh": "multinn_torch.parallel.mesh",
    "init_distributed": "multinn_torch.parallel.mesh",
    "DATA_AXIS": "multinn_torch.parallel.mesh",
    "TRACK_AXIS": "multinn_torch.parallel.mesh",
    "MODEL_AXIS": "multinn_torch.parallel.mesh",
    "SEQ_AXIS": "multinn_torch.parallel.mesh",
    "SeqSpec": "multinn_torch.parallel.seqpipe",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'multinn_torch.parallel' has no attribute '{name}'")
