"""Runnable examples of the port (``python -m gastx_torch.examples.X``)."""
