"""The benchmark of the PyTorch/CUDA port (`deepinpainting_torch`): one
cell a run, `python3 portbench/run.py --workload <cell> ...` (run.py)."""
