"""Training and sampling over torch.distributed (port of
``street_crafter_tpu/parallel``): process groups over named axes
(``mesh``), the sharding rules of the fine-tune (``sharding``), the
exchanges of sequence parallelism over the ``frames`` axis
(``sequence``), the frames-sharded sampler (``sample``) and the kernels'
SPMD bridge with its x2 kernel (``kernel_shard``)."""
