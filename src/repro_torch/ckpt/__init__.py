"""The port's checkpoints (`checkpoint.Checkpointer`), in the reference's
on-disk layout."""
