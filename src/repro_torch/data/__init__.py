"""Host-side data (copies of ``repro.data``): the paper's two classifiers'
datasets, and the LM's counter-based synthetic stream with its resumable
pipeline."""
from repro_torch.data import iris, mnist, pipeline, synthetic

__all__ = ["synthetic", "iris", "mnist", "pipeline"]
