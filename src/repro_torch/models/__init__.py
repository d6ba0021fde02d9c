"""The LM stack of the port: layers, GQA attention, the decoder `LM` and
the carry-across of the JAX package's weights (`convert`)."""
