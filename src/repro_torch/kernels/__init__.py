"""Hand-written CUDA kernels (attention, RMSNorm, SSD scan), their plain
versions and dispatch."""
