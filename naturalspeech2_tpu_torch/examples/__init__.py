"""Runnable probes of the port (``python -m naturalspeech2_tpu_torch.examples.<name>``)."""
