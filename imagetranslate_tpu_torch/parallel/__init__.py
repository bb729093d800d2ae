"""Data and tensor parallelism over ``torch.distributed`` (port of
imagetranslate_tpu/parallel: the mesh and the tensor-parallel rules; the
pipeline, ZeRO-1 and the other trainers' meshes are ROADMAP module 14b)."""
