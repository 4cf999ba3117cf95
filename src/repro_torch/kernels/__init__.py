"""Hand-written CUDA attention kernels, their plain versions and dispatch."""
