"""Data, tensor, expert and pipeline parallelism and ZeRO-1 over
``torch.distributed`` (port of imagetranslate_tpu/parallel: the mesh, the
tensor-parallel rules, ``zero_shard_opt_state`` and the GPipe pipeline; the
other trainers' meshes and the long-document LM's sequence parallelism are
ROADMAP module 14b, parts 4-6)."""
