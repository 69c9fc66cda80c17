"""Data and spatial parallelism over torch.distributed (counterpart of
deepinpainting_tpu/parallel/): `collectives.py` holds the process group
and the spatial context a step runs in and the collectives its layers
take, `mesh.py` the process group's set-up, the batch split and the
data-parallel steps, `spatial.py` the data x sp grid of ranks and the
spatially partitioned steps and inference."""
