"""Core: the paper's LIF network with universal interconnections, in PyTorch."""
