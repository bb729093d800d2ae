"""Data, tensor, expert, pipeline and sequence parallelism and ZeRO-1 over
``torch.distributed`` (port of imagetranslate_tpu/parallel: the mesh, the
tensor-parallel rules, ``seq_sharding``, ``zero_shard_opt_state`` and the
GPipe pipeline), one process a rank, on one machine or several."""
