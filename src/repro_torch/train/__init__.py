"""Training: AdamW with global-norm clipping, checkpoints with exact
resume, and the train loop (the port's ``repro.train``)."""
