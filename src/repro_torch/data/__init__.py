"""Host-side datasets of the paper's two classifiers (copies of ``repro.data``).

``synthetic`` and ``pipeline`` belong to the LM scaffold and arrive with it.
"""
from repro_torch.data import iris, mnist

__all__ = ["iris", "mnist"]
