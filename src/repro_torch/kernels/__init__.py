"""Hand-written Hopper kernels, their plain PyTorch twins and the state bridges."""
