"""Data-parallel training over torch.distributed (port of
``street_crafter_tpu/parallel``): process groups (``mesh``), the sharding
rules of the fine-tune (``sharding``) and the kernels' SPMD bridge with its
x2 kernel (``kernel_shard``)."""
