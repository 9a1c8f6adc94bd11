"""The LiDAR-conditioned video diffusion model (port of
``street_crafter_tpu/models/vdm``)."""
