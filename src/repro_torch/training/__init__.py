"""Training of the port: the AdamW optimizer, the train step and loop, checkpoints."""
