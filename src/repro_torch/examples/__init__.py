"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart`` (the reference's ``examples/quickstart.py``) and
``train_resnet18_e2e``."""
