"""Training (port of ``repro.train``): AdamW over parameter trees, atomic
checkpoints in the reference's layout, and the QAT train step."""
