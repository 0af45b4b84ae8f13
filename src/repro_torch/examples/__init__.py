"""Runnable counterparts of the reference's ``examples/`` (``python -m
repro_torch.examples.<name> [--device cpu]``); they live in the package so
that the port adds no file under ``examples/``."""
