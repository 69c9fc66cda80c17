"""Tensor ops: mask math, torch-geometry layers, IPSR attention and its
CUDA scan kernel."""
