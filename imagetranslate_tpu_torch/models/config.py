"""Typed model configuration (port of imagetranslate_tpu/models/config.py).

Same fields, defaults and JSON as the JAX ``Seq2SeqConfig``, so a
``config.json`` written by either package loads in the other.
``fused_attn_dropout`` routes training attention through the fused dropout
kernel (``ops/train_attention.py``), ``use_pallas_xent`` routes the train
steps' loss through the fused cross-entropy kernels (``ops/xent.py``; the key
keeps the name both packages read), ``use_pallas_attention`` routes a
deterministic attention over S >= 1024 keys through the flash attention kernel
(``ops/flash_attention.py``) when its gate passes, and
``decode_attention_impl="fused"`` routes the self-attention of every decode
step through the beam decode attention kernel (``ops/decode_attention.py``:
bf16 compute and cache on the card, where a head width or a live length the
kernel does not take raises; an fp32 model or an fp32/fp8 cache on the card
takes the plain attention; the op's plain version on the CPU);
``"onehot"`` (the default) and ``"dense"`` take the plain attention over the
masked buffer. ``moe_experts > 0`` puts a routed expert bank in every
encoder and decoder layer's FFN (``models/moe.py``; the ``moe_*`` fields).
``remat`` recomputes every encoder and decoder layer in the backward, and
``remat_ffn`` (without ``remat``) only the FFN (``models/remat.py``), with
the dropout stream replayed, so neither changes the loss or the gradients.
The other knobs that select TPU kernels or XLA lowerings
(``dense_decode_cross``, ``fused_project_topk``) are read and kept but have
no effect here: the port has one path per operation.
"""

from __future__ import annotations

import dataclasses
import json

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name (``dtype``, ``kv_cache_dtype``) -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int
    num_languages: int = 2
    hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    enc_layers: int = 6
    dec_layers: int = 3
    dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 4
    lang_dec: bool = False
    tie_embed: bool = False
    use_proposals: bool = False
    resnet_depth: int = 1
    freeze_image: bool = False
    use_obj: bool = False
    img_size: int = 224
    dtype: str = "bfloat16"
    remat: bool = False
    remat_ffn: bool = False
    use_pallas_attention: bool = True
    fused_attn_dropout: bool = True
    # Defaults to bf16 even for an fp32 model: K/V are stored in this dtype
    # and read back in the compute dtype, as the JAX decode does.
    kv_cache_dtype: str = "bfloat16"
    fp32_logits: bool = True
    decode_attention_impl: str = "onehot"
    dense_decode_cross: bool = False
    fused_project_topk: bool = True
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 256
    moe_aux_weight: float = 0.01
    use_pallas_xent: bool = False

    def __post_init__(self):
        if self.moe_experts and not (1 <= self.moe_top_k <= self.moe_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, "
                f"moe_experts={self.moe_experts}]")
        if self.moe_experts and self.moe_group_size < 0:
            # 0 is one global group (O(T^2) dispatch, for parity checks).
            raise ValueError("moe_group_size must be >= 0")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def kv_dtype(self) -> torch.dtype:
        return torch_dtype(self.kv_cache_dtype)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Seq2SeqConfig":
        raw = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})


def tiny_config(vocab_size: int = 128, num_languages: int = 2,
                **kw) -> Seq2SeqConfig:
    """Small config for tests (same values as the JAX ``tiny_config``)."""
    base = dict(
        vocab_size=vocab_size,
        num_languages=num_languages,
        hidden_size=32,
        num_heads=4,
        intermediate_size=64,
        max_position_embeddings=64,
        enc_layers=2,
        dec_layers=2,
        dropout=0.0,
        attention_dropout=0.0,
        dtype="float32",
        use_pallas_attention=False,
        use_pallas_xent=False,
    )
    base.update(kw)
    return Seq2SeqConfig(**base)
