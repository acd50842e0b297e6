"""The port's command-line scripts, each run as
``python -m multinn_torch.scripts.<name>``: ``prepare_dataset``,
``serve_loadtest``, ``scale_stress``, ``ingest_bench`` and
``real_corpus_drill`` — the counterparts of the repo's ``scripts/``."""
