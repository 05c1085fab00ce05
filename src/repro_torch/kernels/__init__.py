"""Hand-written Hopper kernels, their plain versions and the selector-driven ops."""
