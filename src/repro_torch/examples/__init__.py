"""Runnable examples of the port (``python -m repro_torch.examples.<name>``).
The reference's ``examples/quickstart.py`` defaults to an LM config and
waits for the LM slice (ROADMAP A12)."""
