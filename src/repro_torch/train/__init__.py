"""The port's training: the step (`train_step`: loss, gradients, AdamW,
microbatches, compression) and the fault-tolerant loop (`trainer`)."""
