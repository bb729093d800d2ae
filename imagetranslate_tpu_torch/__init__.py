"""imagetranslate_tpu_torch — the PyTorch/CUDA port of ``imagetranslate_tpu``
for one NVIDIA H100.

The JAX package beside it stays the reference: every module here names its
counterpart, keeps its parameter layout (HF-2.9 ``state_dict`` keys) and its
checkpoint and tokenizer formats, and is tested against it on the CPU. The
port imports neither jax nor the JAX package.

- ``models``    — config, transformer stacks (dense or MoE FFN), ``Seq2Seq``,
                  the LMs, the captioner, ``SenSim`` and ``Caption2Image``
                  as ``nn.Module``s.
- ``ops``       — plain attention, the label-smoothed loss, and the
                  hand-written CUDA kernels with their plain PyTorch versions
                  (``ops/topk_project.py``, ``ops/train_attention.py``).
- ``decoding``  — KV-cached beam search (gather cache semantics).
- ``text``      — the BPE tokenizer (its encode and training in C++ where
                  g++ builds ``text/_native/bpe.cpp``) and the
                  ``TextProcessor`` facade.
- ``data``      — ``.mt`` binarization (marshal or ITR1 records,
                  ``data/recordio.py``), length-bucketed ``MTBatcher`` and
                  ``PrefetchIterator``, the image pipeline (the libjpeg
                  decoder of ``data/imagedec.py``, else Pillow).
- ``train``     — inverse-sqrt Adam, the MT train step, ``MTTrainer``, the
                  weight and optimizer-state bridge to the flax/optax trees
                  and the msgpack checkpoint.
- ``utils``     — step meters, the profiler hook, the g++ build of the
                  host libraries.
- ``cli``       — ``translate``, ``train_mt``, the caption, LM, SenSim and
                  Caption2Image CLIs, ``translate_img``, the host tools and
                  the recipe ladder ``recipe_check``.
- ``comparable``, ``scripts``, ``mmid`` — the corpus-mining toolbox and
                  ``mmid_sim``: host tools with the JAX package's argv and
                  output bytes; ``comparable.sim_calculator`` scores its
                  candidate pairs on the card.
"""

__version__ = "0.1.0"
