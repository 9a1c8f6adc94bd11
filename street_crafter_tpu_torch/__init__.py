"""street_crafter_tpu_torch — the PyTorch/CUDA port of ``street_crafter_tpu``.

The JAX package beside it is the reference; this package mirrors its layout
module by module so each counterpart is easy to find:

  config/          declarative config (JSON or YAML files + CLI overrides)
  ops/             numerical ops (plain torch) and the raster kernels
  csrc/            CUDA C++ sources of the hand-written Hopper kernels
  models/gs/       Gaussian pools, scene graph, renderer, checkpoints
  datasets/        scene readers and cameras
  data_processor/  scene-init point clouds
  runner/          scene orchestration and the render entry point
  utils/, visualizers/  ply/png io, checkpointing, image outputs

It imports ``torch`` and never ``jax``. The CUDA kernels are compiled with
``nvcc`` on first use into ``street_crafter_tpu_torch/build/``.
"""

__version__ = "0.1.0"
