"""BERT-style encoder/decoder stacks (port of
imagetranslate_tpu/models/transformer.py: Embeddings, Attention, FeedForward,
make_ffn, the layers and stacks, OutputLayer, pad_bias, causal_pad_bias,
segment_bias).

Post-LayerNorm blocks, exact-gelu FFN, additive -10000 masks, the language
id as a per-token token-type embedding and learned positions: the math of HF
``transformers==2.9.0`` BertModel. Modules are laid out so that their
``state_dict`` keys are the reference's HF-2.9 names
(``attention.self.query.weight``, ``output.LayerNorm.weight``, ...), which
``imagetranslate_tpu/train/torch_import.py::import_seq2seq`` maps onto the
flax tree.

Dtypes follow the JAX modules (flax ``param_dtype`` / ``dtype``): Linear and
Embedding weights are STORED in ``param_dtype`` and cast to the compute dtype
(``cfg.dtype``) at each use. A model built for training holds fp32 masters
(``param_dtype=torch.float32``); a model built for serving stores the compute
dtype (the default; the casts are then no-ops, the counterpart of the JAX
``cast_params``). LayerNorms run in fp32 on fp32 parameters and cast back, and
the decode KV cache is stored in ``cfg.kv_cache_dtype`` and read back in the
compute dtype.

Dropout (after the embedding LayerNorm, on the attention probabilities, on
the attention output projection and on the FFN output, as in the JAX
modules) is on where a ``DropoutRng`` is handed down (``drop``), and off
where it is None: the decode path never takes one.

Recompute (``models/remat.py``): with ``cfg.remat`` every encoder and
decoder layer's training forward is recomputed in the backward, with
``cfg.remat_ffn`` (and not ``remat``) only the FFN, dense or MoE; only under
autograd, so the decodes and the incremental ``step`` are never wrapped. The
dropout stream replays in the recompute: from one seed the loss and the
gradients are those without recompute, as under the JAX ``nn.remat``.

Tensor parallelism (``Seq2Seq.shard_``; the JAX TP rules of
parallel/mesh.py): a module whose ``tp`` is a ``ProcessMesh`` holds its
rank's shard, H/n heads of Q, K, V and the matching input columns of the
attention output, F/n of the FFN intermediate and of the FFN output's input,
V/n rows of the word embedding. The products of the split input columns are
summed over the model group before the replicated bias is added once;
``tp_copy`` sums the gradients of the inputs that reach every rank whole.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.moe import MoEFeedForward
from imagetranslate_tpu_torch.models.remat import checkpointed
from imagetranslate_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_bias,
)
from imagetranslate_tpu_torch.ops.decode_attention import (
    decode_attention,
    kernel_dtypes,
)
from imagetranslate_tpu_torch.parallel.comm import tp_copy, tp_reduce

# Per decoder layer: self-attention K/V buffers "k", "v" [B, L, H, D] in the
# cache dtype, and the once-projected encoder K/V "ek", "ev" [B, S, H, D].
Cache = List[Dict[str, torch.Tensor]]


class DropoutRng:
    """The dropout stream of one forward pass, the counterpart of flax's
    ``rngs={"dropout": key}`` + ``make_rng``. Seeds for the fused attention
    kernel are drawn from the caller's host generator (no device sync);
    elementwise masks come from a device generator seeded from it.

    Under a ``mesh`` every rank draws the same host seeds. The device
    generator is shifted by the data index, so the ranks of a model group
    (which hold the same rows) drop the same replicated activations; an
    attention seed is shifted by the linear shard index where the heads are
    split (the JAX call site's shift) and by the data index's first shard
    where they are not. Under sequence parallelism (``seq``: the ranks of a
    model group hold different positions of the same rows) the device
    generator is shifted by the linear shard index. ``seed`` is the
    unshifted seed, the same on every rank: draws that must be those of the
    global batch (the MLM masks) start from it."""

    mesh = None

    def __init__(self, generator: torch.Generator, device, mesh=None,
                 seq: bool = False):
        self.host = generator
        self.mesh = mesh
        self.dev = torch.Generator(device=device)
        self.seed = self.next_seed()
        self.dev.manual_seed(self.seed + (0 if mesh is None else
                                          mesh.rank if seq else mesh.d))

    def get_state(self):
        """Where the stream stands: both generators' states."""
        return self.host.get_state(), self.dev.get_state()

    def set_state(self, state):
        self.host.set_state(state[0])
        self.dev.set_state(state[1])

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.host))

    def attention_seed(self, heads_split: bool) -> int:
        mesh = self.mesh
        if mesh is None:
            return self.next_seed()
        return self.next_seed() + (mesh.rank if heads_split
                                   else mesh.d * mesh.n_model)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
        divided by it."""
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.dev,
                          device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), 0.0)


def dropout_stream(deterministic: bool, rng, device, mesh=None,
                   seq: bool = False) -> Optional[DropoutRng]:
    """The ``drop`` a model's forward hands down: None when deterministic,
    else ``rng`` itself if it is a DropoutRng, else a new one over ``rng``
    (the host torch.Generator the dropout seeds come from) for ``mesh``."""
    if deterministic:
        return None
    if rng is None:
        raise ValueError("deterministic=False needs rng, the "
                         "torch.Generator the dropout seeds come from")
    return (rng if isinstance(rng, DropoutRng)
            else DropoutRng(rng, device, mesh, seq))


def _group(tp):
    return None if tp is None else tp.model_group


def row_parallel(dense: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """``dense(x)`` for a Linear whose input columns are split over the
    model group (``tp``; None: not split): the partial products summed over
    the group, then the replicated bias added once."""
    if tp is None:
        return dense(x)
    out = tp_reduce(F.linear(x, dense.weight.to(x.dtype)), tp.model_group)
    return out + dense.bias.to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast to the input's (compute)
    dtype at each use, so they may be stored as fp32 masters."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Embedding(nn.Embedding):
    """nn.Embedding that returns rows in the compute dtype whatever dtype
    the table is stored in."""

    def __init__(self, num, dim, compute_dtype, **kw):
        super().__init__(num, dim, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.compute_dtype)


def _param_dtype(cfg: Seq2SeqConfig, param_dtype) -> torch.dtype:
    return cfg.compute_dtype if param_dtype is None else param_dtype


def _linear(cfg: Seq2SeqConfig, din: int, dout: int, device,
            param_dtype=None) -> Linear:
    return Linear(din, dout, device=device,
                  dtype=_param_dtype(cfg, param_dtype))


def _layer_norm(cfg: Seq2SeqConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                        device=device, dtype=torch.float32)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, cast back to the input dtype."""
    return ln(x.to(torch.float32)).to(x.dtype)


class Embeddings(nn.Module):
    """word + position + language (token-type) embeddings -> LayerNorm ->
    dropout."""

    tp = None   # the mesh when the word table's rows are split

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        kw = dict(device=device, dtype=_param_dtype(cfg, param_dtype))
        cd = cfg.compute_dtype
        self.word_embeddings = Embedding(cfg.vocab_size, E, cd, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, E,
                                             cd, **kw)
        self.token_type_embeddings = Embedding(max(1, cfg.num_languages), E,
                                               cd, **kw)
        self.LayerNorm = _layer_norm(cfg, device)

    def embed_words(self, ids: torch.Tensor) -> torch.Tensor:
        """Word-table rows in the compute dtype. With the table's rows split
        over the model group, each rank looks up the ids of its own range,
        zeros elsewhere, and the group sums them."""
        if self.tp is None:
            return self.word_embeddings(ids)
        w = self.word_embeddings.weight
        local = ids - self.tp.m * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        x = F.embedding(torch.where(inside, local, 0), w)
        x = x.masked_fill(~inside[..., None], 0.0).to(self.cfg.compute_dtype)
        return tp_reduce(x, self.tp.model_group)

    def forward(self, input_ids, position_ids, lang_ids,
                drop: Optional[DropoutRng] = None):
        x = (self.embed_words(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(lang_ids))
        x = layer_norm(self.LayerNorm, x)
        return x if drop is None else drop.dropout(x, self.cfg.dropout)


class Attention(nn.Module):
    """BertSelfAttention + BertSelfOutput: multi-head attention with a
    post-LN residual block, and an optional KV cache for one-token decode."""

    tp = None   # the mesh when the heads are split

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.self = nn.ModuleDict({n: _linear(cfg, E, E, device, param_dtype)
                                   for n in ("query", "key", "value")})
        self.output = nn.ModuleDict({
            "dense": _linear(cfg, E, E, device, param_dtype),
            "LayerNorm": _layer_norm(cfg, device)})

    @property
    def heads(self) -> int:
        """The heads this rank holds (all of them without a split)."""
        return self.self["query"].weight.shape[0] // self.cfg.head_dim

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], -1, self.cfg.head_dim)

    def project_kv(self, kv: torch.Tensor):
        """Encoder states -> (k, v) [B, S, H, D], once per sequence (the
        cross-attention cache)."""
        return (self._heads(self.self["key"](kv)),
                self._heads(self.self["value"](kv)))

    def forward(self, x, kv, bias, cache: Optional[Dict] = None,
                index: Optional[int] = None, precomputed_kv=None,
                drop: Optional[DropoutRng] = None, fused: bool = False):
        """x [B, T, E] queries; kv [B, S, E] keys/values (self-attention:
        kv = x). With ``cache`` (a layer's dict) the new K/V are written in
        place at position ``index`` of cache["k"]/["v"]; attention then reads
        the whole buffer under ``bias``, or, with ``fused`` (one query token,
        see ``Decoder.fused_decode_step``), positions ``0 .. index`` through
        ``ops/decode_attention.py`` in the cache's own dtype, ``bias`` unread.
        With ``precomputed_kv`` = (k, v) the projections are skipped
        (cross-attention in decode). ``drop`` turns on the
        attention-probability and output dropout."""
        cfg = self.cfg
        g = _group(self.tp)
        xin = tp_copy(x, g)
        q = self._heads(self.self["query"](xin))
        ctx = None
        if precomputed_kv is not None:
            k, v = precomputed_kv
        else:
            k, v = self.project_kv(xin if kv is x else tp_copy(kv, g))
            if cache is not None:
                T = k.shape[1]
                cache["k"][:, index:index + T] = k.to(cache["k"].dtype)
                cache["v"][:, index:index + T] = v.to(cache["v"].dtype)
                if fused:
                    if T != 1:
                        raise ValueError("the fused decode step takes one "
                                         f"query token a row, got {T}")
                    ctx = decode_attention(
                        q[:, 0], cache["k"][:, :index + 1],
                        cache["v"][:, :index + 1])[:, None]
                else:
                    k = cache["k"].to(cfg.compute_dtype)
                    v = cache["v"].to(cfg.compute_dtype)
        if ctx is None:
            ctx = dot_product_attention(
                q, k, v, bias, dropout_rate=cfg.attention_dropout,
                deterministic=drop is None,
                seed=(None if drop is None
                      else drop.attention_seed(self.tp is not None)),
                use_pallas=cfg.use_pallas_attention,
                use_fused_dropout=cfg.fused_attn_dropout)
        out = row_parallel(self.output["dense"],
                           ctx.reshape(*ctx.shape[:2], -1), self.tp)
        if drop is not None:
            out = drop.dropout(out, cfg.dropout)
        return layer_norm(self.output["LayerNorm"], out + x)


class EncoderLayer(nn.Module):
    """BertLayer: self-attention, then the dense-gelu-dense FFN with a
    post-LN residual (BertIntermediate + BertOutput), or with
    ``cfg.moe_experts > 0`` the routed expert bank ``moe``
    (``models/moe.py``, the JAX ``make_ffn``) in the FFN's place."""

    tp = None   # the mesh when the FFN's F is split

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        E, FF = cfg.hidden_size, cfg.intermediate_size
        self.attention = Attention(cfg, device, param_dtype)
        if cfg.moe_experts:
            self.moe = MoEFeedForward(cfg, device, param_dtype)
            return
        self.intermediate = nn.ModuleDict({
            "dense": _linear(cfg, E, FF, device, param_dtype)})
        self.output = nn.ModuleDict({
            "dense": _linear(cfg, FF, E, device, param_dtype),
            "LayerNorm": _layer_norm(cfg, device)})

    def ffn(self, x, drop: Optional[DropoutRng] = None):
        """The FFN block; under autograd with ``cfg.remat_ffn`` (and not
        ``cfg.remat``, which recomputes the whole layer) its activations
        are recomputed in the backward."""
        cfg = self.cfg
        if cfg.remat_ffn and not cfg.remat and torch.is_grad_enabled():
            return checkpointed(self._ffn, drop, x)
        return self._ffn(x, drop)

    def _ffn(self, x, drop: Optional[DropoutRng] = None):
        if self.cfg.moe_experts:
            return self.moe(x, drop)
        h = F.gelu(self.intermediate["dense"](tp_copy(x, _group(self.tp))))
        out = row_parallel(self.output["dense"], h, self.tp)  # exact gelu
        if drop is not None:
            out = drop.dropout(out, self.cfg.dropout)
        return layer_norm(self.output["LayerNorm"], out + x)

    def forward(self, x, bias, drop: Optional[DropoutRng] = None):
        return self.ffn(self.attention(x, x, bias, drop=drop), drop)


class DecoderLayer(EncoderLayer):
    """BertLayer with cross-attention over the encoder states."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__(cfg, device, param_dtype)
        self.crossattention = Attention(cfg, device, param_dtype)

    def forward(self, x, enc, self_bias, cross_bias,
                drop: Optional[DropoutRng] = None):
        x = self.attention(x, x, self_bias, drop=drop)
        x = self.crossattention(x, enc, cross_bias, drop=drop)
        return self.ffn(x, drop)

    def step(self, x, cache: Dict, index: int, cross_bias, self_bias,
             fused: bool = False):
        """One-token decode; writes this token's K/V into ``cache``. With
        ``fused`` the self-attention reads positions ``0 .. index`` through
        ``ops/decode_attention.py`` and ``self_bias`` is unread."""
        x = self.attention(x, x, self_bias, cache=cache, index=index,
                           fused=fused)
        x = self.crossattention(x, None, cross_bias,
                                precomputed_kv=(cache["ek"], cache["ev"]))
        return self.ffn(x)


class LayerStack(nn.Module):
    """HF BertEncoder: holds the layers under ``.layer``."""

    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


def pad_bias(pad_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] keep-mask -> additive [B, 1, 1, S] bias."""
    return make_attention_bias(pad_mask[:, None, None, :])


def causal_pad_bias(pad_mask: torch.Tensor) -> torch.Tensor:
    """Causal AND target-pad keep-mask as an additive [B, 1, T, T] bias."""
    T = pad_mask.shape[-1]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=pad_mask.device))
    keep = causal[None, :, :] & pad_mask[:, None, :]
    return make_attention_bias(keep[:, None, :, :])


def segment_bias(seg_q: torch.Tensor, seg_k: torch.Tensor,
                 causal: bool = False) -> torch.Tensor:
    """Packed-sequence attention bias: [B, Tq] x [B, Tk] segment ids (0 =
    padding) -> additive [B, 1, Tq, Tk] bias keeping only same-segment pairs
    (and the causal triangle for decoder self-attention). With one segment
    per row this reduces exactly to the pad/causal biases."""
    keep = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_k[:, None, :] > 0)
    if causal:
        T = seg_q.shape[1]
        keep = keep & torch.tril(torch.ones((T, T), dtype=torch.bool,
                                            device=seg_q.device))[None]
    return make_attention_bias(keep[:, None, :, :])


class Encoder(nn.Module):
    """The reference's encoder BertModel: the (shared) embeddings and the
    layer stack. ``forward`` takes embedded input so the parent owns the
    embedding call."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, device, param_dtype)
        self.encoder = LayerStack([EncoderLayer(cfg, device, param_dtype)
                                   for _ in range(cfg.enc_layers)])

    def forward(self, x, bias, drop: Optional[DropoutRng] = None):
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.encoder.layer:
            x = (checkpointed(layer, drop, x, bias) if remat
                 else layer(x, bias, drop))
        return x


class Decoder(nn.Module):
    """Causal decoder stack with cross-attention (reference
    BertDecoderModel). Its embeddings are the encoder's (shared)."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = LayerStack([DecoderLayer(cfg, device, param_dtype)
                                   for _ in range(cfg.dec_layers)])

    def forward(self, x, enc, self_bias, cross_bias,
                drop: Optional[DropoutRng] = None):
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.decoder.layer:
            x = (checkpointed(layer, drop, x, enc, self_bias, cross_bias)
                 if remat else layer(x, enc, self_bias, cross_bias, drop))
        return x

    def init_cache(self, enc_states, batch: int, max_len: int) -> Cache:
        """Zeroed self-attention K/V buffers + once-projected encoder K/V."""
        cfg = self.cfg
        cache = []
        for layer in self.decoder.layer:
            shape = (batch, max_len, layer.attention.heads, cfg.head_dim)
            ek, ev = layer.crossattention.project_kv(enc_states)
            cache.append({
                "k": torch.zeros(shape, dtype=cfg.kv_dtype,
                                 device=enc_states.device),
                "v": torch.zeros(shape, dtype=cfg.kv_dtype,
                                 device=enc_states.device),
                "ek": ek,
                "ev": ev,
            })
        return cache

    def fused_decode_step(self, x, cache: Cache) -> bool:
        """Does this step's self-attention go through
        ``ops/decode_attention.py``? With ``decode_attention_impl="fused"``:
        always for a CPU tensor (the op's plain version), and on the card by
        the dtypes alone (bf16 compute and cache): a head width or a live
        length the kernel does not take then raises in the op, it does not
        take the plain attention. An fp32 model or an fp32/fp8 cache on the
        card takes the plain attention, as do ``"onehot"`` and ``"dense"``
        (in the JAX package two lowerings of the same math)."""
        cfg = self.cfg
        if cfg.decode_attention_impl != "fused" or x.shape[1] != 1:
            return False
        return x.device.type == "cpu" or kernel_dtypes(
            cfg.compute_dtype, cache[0]["k"].dtype)

    def step(self, x, cache: Cache, index: int, cross_bias):
        """One decode step on embedded tokens x [B, 1, E]; updates the
        cache's self-attention buffers in place."""
        fused = self.fused_decode_step(x, cache)
        if fused:
            self_bias = None     # positions 0 .. index, read by the fused op
        else:
            L = cache[0]["k"].shape[1]
            keep = torch.arange(L, device=x.device) <= index
            self_bias = make_attention_bias(keep)[None, None, None, :]
        for layer, c in zip(self.decoder.layer, cache):
            x = layer.step(x, c, index, cross_bias, self_bias, fused)
        return x


class OutputLayer(nn.Module):
    """Reference BertOutputLayer, a Linear with bias, as the parameters
    ``layer.weight`` [V, E] (stored in ``param_dtype``) and ``layer.bias``
    [V] (fp32, the precision the projection adds it in). With ``tie_embed``
    the weight is the word-embedding table and only the bias is a parameter
    here. ``Seq2Seq.project``/``project_topk`` do the math."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None):
        super().__init__()
        V, E = cfg.vocab_size, cfg.hidden_size
        self.layer = nn.Module()
        if not cfg.tie_embed:
            self.layer.weight = nn.Parameter(torch.zeros(
                (V, E), dtype=_param_dtype(cfg, param_dtype), device=device))
        self.layer.bias = nn.Parameter(torch.zeros(
            V, dtype=torch.float32, device=device))
