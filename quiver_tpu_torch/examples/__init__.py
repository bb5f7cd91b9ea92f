"""Runnable examples of the port (``python -m quiver_tpu_torch.examples.<name>``)."""
