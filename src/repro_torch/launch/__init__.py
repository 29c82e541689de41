"""Entry points that drive the port's models: the batched LM server and the
training loop."""
