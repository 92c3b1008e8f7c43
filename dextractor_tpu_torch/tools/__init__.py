"""Measurement tools of the port (``python -m dextractor_tpu_torch.tools.<name>``)."""
