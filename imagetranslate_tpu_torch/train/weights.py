"""Weight bridge between the JAX package's flax parameter tree and the
port's ``state_dict`` (``state_dict_from_flax`` is the inverse of
imagetranslate_tpu/train/torch_import.py::import_seq2seq, and
``flax_from_state_dict`` does what that importer does, plus the proposal gate).

The port's parameter names are the reference's HF-2.9 ``state_dict`` keys, so
``import_seq2seq`` maps a port ``state_dict`` straight onto the flax tree and
``state_dict_from_flax`` maps it back. Layout facts (those of the importer):
flax Dense kernels are [in, out], torch Linear weights [out, in]; attention
projections are DenseGeneral [E, H, D] and out [H, D, E]; the encoder and
decoder share one embedding table, written under ``encoder.embeddings.*``.
Both directions keep each leaf's dtype, so a trainer's fp32 masters cross as
fp32 and a serving model's bf16 weights as bf16.

``flax_from_opt_state`` / ``opt_state_from_flax`` carry the optimizer state
across in the optax chain's layout (what flax serializes a chain state to:
a map numbered by chain position, ``ScaleByAdamState`` as count/mu/nu,
``ScaleByScheduleState`` as count, the stateless members as empty maps, and
``optax.MultiSteps`` around it when gradients accumulate); the moments and the
accumulated gradients are parameter-shaped trees and go through the same
layout maps as the parameters.

A layer whose ``ffn`` is an MoE bank (``router``, ``wi``, ``bi``, ``wo``,
``bo``, ``ln``) maps to keys under ``{layer}.moe``; every other key is the
dense model's.

One ``Bridge`` per model: ``SEQ2SEQ``, ``LM``, ``LONGDOC``, ``SENSIM``,
``CAPTION2IMAGE`` and ``CAPTION`` (the
captioning model's variables are ``{"params", "batch_stats"}``: the ResNet's
running statistics cross as ``state_dict`` buffers), ``CAPTION_PARAMS``
for the caption trainer's optimizer state, whose moments are trees of the
``params`` collection alone, and ``DETECTOR`` for the Faster R-CNN, whose
``state_dict`` is torchvision's (``load_torchvision_frcnn`` reads a
torchvision checkpoint; ``random_frcnn_state_dict`` draws one).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple

import numpy as np
import torch

from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.train.optimizer import (
    AnyOptState,
    MultiSteps,
    MultiStepsState,
    Optimizer,
    OptState,
)


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def _attn(sd, prefix: str, p: Mapping, E: int):
    """An attention sub-tree -> its keys. The head dims fold into one
    (-1): a tensor-parallel shard of the tree ([E, H/n, D] kernels) maps to
    the same rows of the port's shard."""
    for name in ("query", "key", "value"):
        sd[f"{prefix}.self.{name}.weight"] = _t(p[name]["kernel"]).reshape(
            E, -1).T
        sd[f"{prefix}.self.{name}.bias"] = _t(p[name]["bias"]).reshape(-1)
    sd[f"{prefix}.output.dense.weight"] = _t(p["out"]["kernel"]).reshape(
        -1, E).T
    sd[f"{prefix}.output.dense.bias"] = _t(p["out"]["bias"])
    sd[f"{prefix}.output.LayerNorm.weight"] = _t(p["ln"]["scale"])
    sd[f"{prefix}.output.LayerNorm.bias"] = _t(p["ln"]["bias"])


_MOE = ("wi", "bi", "wo", "bo")


def _ffn(sd, prefix: str, p: Mapping):
    """A layer's ``ffn`` sub-tree -> its keys: the dense FFN's, or an MoE
    bank's under ``{prefix}.moe`` (router [E, H] as a Linear weight, the
    stacked expert weights as they are, ``ln``)."""
    if "router" in p:
        sd[f"{prefix}.moe.router.weight"] = _t(p["router"]["kernel"]).T
        for name in _MOE:
            sd[f"{prefix}.moe.{name}"] = _t(p[name])
        sd[f"{prefix}.moe.ln.weight"] = _t(p["ln"]["scale"])
        sd[f"{prefix}.moe.ln.bias"] = _t(p["ln"]["bias"])
        return
    for name in ("intermediate", "output"):
        sd[f"{prefix}.{name}.dense.weight"] = _t(p[name]["kernel"]).T
        sd[f"{prefix}.{name}.dense.bias"] = _t(p[name]["bias"])
    sd[f"{prefix}.output.LayerNorm.weight"] = _t(p["ln"]["scale"])
    sd[f"{prefix}.output.LayerNorm.bias"] = _t(p["ln"]["bias"])


def _embeddings_sd(sd, emb: str, ep: Mapping):
    """An ``Embeddings`` sub-tree -> the keys under ``emb``."""
    sd[f"{emb}.word_embeddings.weight"] = _t(ep["word"]["embedding"])
    sd[f"{emb}.position_embeddings.weight"] = _t(ep["position"]["embedding"])
    sd[f"{emb}.token_type_embeddings.weight"] = _t(ep["lang"]["embedding"])
    sd[f"{emb}.LayerNorm.weight"] = _t(ep["ln"]["scale"])
    sd[f"{emb}.LayerNorm.bias"] = _t(ep["ln"]["bias"])


def _decoder_sd(sd, dec: str, p: Mapping, cfg: Seq2SeqConfig):
    """A ``Decoder`` sub-tree (``layers_i``) -> the keys under ``dec``."""
    for i in range(cfg.dec_layers):
        lp, pre = p[f"layers_{i}"], f"{dec}.decoder.layer.{i}"
        _attn(sd, f"{pre}.attention", lp["self_attn"], cfg.hidden_size)
        _attn(sd, f"{pre}.crossattention", lp["cross_attn"], cfg.hidden_size)
        _ffn(sd, pre, lp["ffn"])


def _encoder_sd(sd, p: Mapping, cfg: Seq2SeqConfig):
    """The ``embeddings`` and ``encoder`` sub-trees (those of ``Seq2Seq`` and
    of ``LM``) -> the ``encoder.*`` keys."""
    E = cfg.hidden_size
    _embeddings_sd(sd, "encoder.embeddings", p["embeddings"])

    for i in range(cfg.enc_layers):
        lp, pre = p["encoder"][f"layers_{i}"], f"encoder.encoder.layer.{i}"
        _attn(sd, f"{pre}.attention", lp["self_attn"], E)
        _ffn(sd, pre, lp["ffn"])


def _contiguous_sd(sd):
    return {k: v.contiguous() for k, v in sd.items()}


def state_dict_from_flax(params: Mapping,
                         cfg: Seq2SeqConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``Seq2Seq`` params (``{"params": {...}}`` or the inner dict;
    leaves numpy arrays or tensors) -> the port's ``state_dict``."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    _encoder_sd(sd, p, cfg)

    n_dec = cfg.num_languages if cfg.lang_dec else 1
    for d in range(n_dec):
        dec = f"decoder.{d}" if cfg.lang_dec else "decoder"
        out = f"output_layer.{d}.layer" if cfg.lang_dec else "output_layer.layer"
        _decoder_sd(sd, dec, p[f"decoders_{d}"], cfg)
        if cfg.tie_embed:
            sd[f"{out}.bias"] = _t(p[f"out_bias_{d}"])
        else:
            proj = p[f"output_layers_{d}"]["proj"]
            sd[f"{out}.weight"] = _t(proj["kernel"]).T
            sd[f"{out}.bias"] = _t(proj["bias"])

    if cfg.use_proposals:
        pa = p["proposal_attn"]
        sd["proposal_attn.gate"] = _t(pa["gate"])
        sd["proposal_attn.LayerNorm.weight"] = _t(pa["ln"]["scale"])
        sd["proposal_attn.LayerNorm.bias"] = _t(pa["ln"]["bias"])
    return _contiguous_sd(sd)


def state_dict_shard_from_flax(params: Mapping, cfg: Seq2SeqConfig,
                               mesh) -> Dict[str, torch.Tensor]:
    """One rank's shard (``mesh``: a ``parallel.mesh.ProcessMesh``) of the
    port's ``state_dict`` of a full JAX ``Seq2Seq`` tree: the TP rules'
    ``shard_params`` after ``state_dict_from_flax``."""
    from imagetranslate_tpu_torch.parallel.mesh import (
        shard_params,
        shard_plan,
    )

    sd = state_dict_from_flax(params, cfg)
    plan = shard_plan({k: tuple(v.shape) for k, v in sd.items()}, mesh, cfg)
    return shard_params(sd, mesh, plan)


def _attn_tree(sd, prefix: str, H: int, D: int) -> dict:
    E = H * D
    tree = {name: {
        "kernel": sd[f"{prefix}.self.{name}.weight"].T.reshape(E, H, D),
        "bias": sd[f"{prefix}.self.{name}.bias"].reshape(H, D)}
        for name in ("query", "key", "value")}
    tree["out"] = {
        "kernel": sd[f"{prefix}.output.dense.weight"].T.reshape(H, D, E),
        "bias": sd[f"{prefix}.output.dense.bias"]}
    tree["ln"] = _ln_tree(sd, f"{prefix}.output.LayerNorm")
    return tree


def _ffn_tree(sd, prefix: str) -> dict:
    if f"{prefix}.moe.wi" in sd:
        tree = {name: sd[f"{prefix}.moe.{name}"] for name in _MOE}
        tree["router"] = {"kernel": sd[f"{prefix}.moe.router.weight"].T}
        tree["ln"] = _ln_tree(sd, f"{prefix}.moe.ln")
        return tree
    tree = {name: {"kernel": sd[f"{prefix}.{name}.dense.weight"].T,
                   "bias": sd[f"{prefix}.{name}.dense.bias"]}
            for name in ("intermediate", "output")}
    tree["ln"] = _ln_tree(sd, f"{prefix}.output.LayerNorm")
    return tree


def _ln_tree(sd, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _embeddings_tree(sd, emb: str) -> dict:
    return {
        "word": {"embedding": sd[f"{emb}.word_embeddings.weight"]},
        "position": {"embedding": sd[f"{emb}.position_embeddings.weight"]},
        "lang": {"embedding": sd[f"{emb}.token_type_embeddings.weight"]},
        "ln": _ln_tree(sd, f"{emb}.LayerNorm")}


def _decoder_tree(sd, dec: str, cfg: Seq2SeqConfig) -> dict:
    H, D = cfg.num_heads, cfg.head_dim
    tree = {}
    for i in range(cfg.dec_layers):
        pre = f"{dec}.decoder.layer.{i}"
        tree[f"layers_{i}"] = {
            "self_attn": _attn_tree(sd, f"{pre}.attention", H, D),
            "cross_attn": _attn_tree(sd, f"{pre}.crossattention", H, D),
            "ffn": _ffn_tree(sd, pre)}
    return tree


def _encoder_tree(sd, cfg: Seq2SeqConfig) -> dict:
    """The ``encoder.*`` keys -> the ``embeddings`` and ``encoder``
    sub-trees."""
    H, D = cfg.num_heads, cfg.head_dim
    p = {"embeddings": _embeddings_tree(sd, "encoder.embeddings")}
    p["encoder"] = {}
    for i in range(cfg.enc_layers):
        pre = f"encoder.encoder.layer.{i}"
        p["encoder"][f"layers_{i}"] = {
            "self_attn": _attn_tree(sd, f"{pre}.attention", H, D),
            "ffn": _ffn_tree(sd, pre)}
    return p


def _contiguous_tree(tree):
    if isinstance(tree, dict):
        return {k: _contiguous_tree(v) for k, v in tree.items()}
    return tree.contiguous()


def flax_from_state_dict(sd: Mapping[str, torch.Tensor],
                         cfg: Seq2SeqConfig) -> dict:
    """The port's ``state_dict`` -> the JAX ``Seq2Seq`` params tree
    ``{"params": {...}}`` (contiguous CPU tensors), the inverse of
    ``state_dict_from_flax``; ``checkpoint.save_params`` writes it."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    p = _encoder_tree(sd, cfg)
    n_dec = cfg.num_languages if cfg.lang_dec else 1
    for d in range(n_dec):
        dec = f"decoder.{d}" if cfg.lang_dec else "decoder"
        out = f"output_layer.{d}.layer" if cfg.lang_dec else "output_layer.layer"
        p[f"decoders_{d}"] = _decoder_tree(sd, dec, cfg)
        if cfg.tie_embed:
            p[f"out_bias_{d}"] = sd[f"{out}.bias"]
        else:
            p[f"output_layers_{d}"] = {"proj": {
                "kernel": sd[f"{out}.weight"].T, "bias": sd[f"{out}.bias"]}}
    if cfg.use_proposals:
        p["proposal_attn"] = {"gate": sd["proposal_attn.gate"],
                              "ln": _ln_tree(sd, "proposal_attn.LayerNorm")}
    return {"params": _contiguous_tree(p)}


def random_params(cfg: Seq2SeqConfig, seed: int = 0) -> dict:
    """Random flax-layout ``Seq2Seq`` params from
    ``numpy.random.RandomState(seed)``, with the JAX model's initializers:
    normal(initializer_range) for kernels and embeddings (an MoE bank's
    router and experts too), zero biases, unit LayerNorm scales, a 0.1
    proposal gate. fp32 numpy leaves."""
    rng = np.random.RandomState(seed)
    E, H, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    FF, V = cfg.intermediate_size, cfg.vocab_size

    def normal(*shape):
        return (rng.standard_normal(shape) * cfg.initializer_range).astype(
            np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ln():
        return {"scale": np.ones((E,), np.float32), "bias": zeros(E)}

    def attn():
        qkv = {n: {"kernel": normal(E, H, D), "bias": zeros(H, D)}
               for n in ("query", "key", "value")}
        return {**qkv, "out": {"kernel": normal(H, D, E), "bias": zeros(E)},
                "ln": ln()}

    def ffn():
        if cfg.moe_experts:
            n = cfg.moe_experts
            return {"router": {"kernel": normal(E, n)},
                    "wi": normal(n, E, FF), "bi": zeros(n, FF),
                    "wo": normal(n, FF, E), "bo": zeros(n, E), "ln": ln()}
        return {"intermediate": {"kernel": normal(E, FF), "bias": zeros(FF)},
                "output": {"kernel": normal(FF, E), "bias": zeros(E)},
                "ln": ln()}

    p = {"embeddings": {
        "word": {"embedding": normal(V, E)},
        "position": {"embedding": normal(cfg.max_position_embeddings, E)},
        "lang": {"embedding": normal(max(1, cfg.num_languages), E)},
        "ln": ln()}}
    p["encoder"] = {f"layers_{i}": {"self_attn": attn(), "ffn": ffn()}
                    for i in range(cfg.enc_layers)}
    n_dec = cfg.num_languages if cfg.lang_dec else 1
    for d in range(n_dec):
        p[f"decoders_{d}"] = {
            f"layers_{i}": {"self_attn": attn(), "cross_attn": attn(),
                            "ffn": ffn()}
            for i in range(cfg.dec_layers)}
        if cfg.tie_embed:
            p[f"out_bias_{d}"] = zeros(V)
        else:
            p[f"output_layers_{d}"] = {"proj": {"kernel": normal(E, V),
                                                "bias": zeros(V)}}
    if cfg.use_proposals:
        p["proposal_attn"] = {"gate": np.full((1, E), 0.1, np.float32),
                              "ln": ln()}
    return {"params": p}


# ---------------- the LM and the long-document LM ----------------

def lm_state_dict_from_flax(params: Mapping,
                            cfg: Seq2SeqConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``LM`` params -> the port's ``LM.state_dict()``: the
    ``embeddings`` and ``encoder`` sub-trees as in ``Seq2Seq``, plus
    ``out_bias``."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    _encoder_sd(sd, p, cfg)
    sd["out_bias"] = _t(p["out_bias"])
    return _contiguous_sd(sd)


def flax_from_lm_state_dict(sd: Mapping[str, torch.Tensor],
                            cfg: Seq2SeqConfig) -> dict:
    """The inverse of ``lm_state_dict_from_flax``."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    p = _encoder_tree(sd, cfg)
    p["out_bias"] = sd["out_bias"]
    return {"params": _contiguous_tree(p)}


def _random_text_encoder(cfg: Seq2SeqConfig, seed: int):
    """(params of the embeddings and the encoder as ``random_params`` draws
    them, the generator to draw the rest from)."""
    p = random_params(dataclasses.replace(
        cfg, dec_layers=0, tie_embed=True, lang_dec=False,
        use_proposals=False), seed)["params"]
    return ({"embeddings": p["embeddings"], "encoder": p["encoder"]},
            np.random.RandomState(seed + 1))


def random_lm_params(cfg: Seq2SeqConfig, seed: int = 0) -> dict:
    """Random flax-layout ``LM`` params: the embeddings and the encoder that
    ``random_params`` draws from the same seed, and a zero ``out_bias``."""
    p, _ = _random_text_encoder(cfg, seed)
    p["out_bias"] = np.zeros((cfg.vocab_size,), np.float32)
    return {"params": p}


_LONGDOC_EMBED = ("word", "position", "lang")


def longdoc_state_dict_from_flax(params: Mapping,
                                 cfg: Seq2SeqConfig) -> Dict[str,
                                                             torch.Tensor]:
    """The JAX ``LongDocLM`` params -> the port's ``LongDocLM.state_dict()``.
    The layers' projections are DenseGeneral kernels [E, H, D] (query, key,
    value) and [H, D, E] (out)."""
    p = params.get("params", params)
    E = cfg.hidden_size
    sd: Dict[str, torch.Tensor] = {}
    for name in _LONGDOC_EMBED:
        sd[f"{name}.weight"] = _t(p[name]["embedding"])
    sd["ln.weight"], sd["ln.bias"] = _t(p["ln"]["scale"]), _t(p["ln"]["bias"])
    for i in range(cfg.enc_layers):
        lp, pre = p[f"layers_{i}"], f"layers.{i}"
        for name in ("query", "key", "value", "out"):
            sd[f"{pre}.{name}.weight"] = _t(lp[name]["kernel"]).reshape(
                E, E).T
            sd[f"{pre}.{name}.bias"] = _t(lp[name]["bias"]).reshape(E)
        for name in ("intermediate", "output"):
            sd[f"{pre}.{name}.weight"] = _t(lp[name]["kernel"]).T
            sd[f"{pre}.{name}.bias"] = _t(lp[name]["bias"])
        for name in ("ln1", "ln2"):
            sd[f"{pre}.{name}.weight"] = _t(lp[name]["scale"])
            sd[f"{pre}.{name}.bias"] = _t(lp[name]["bias"])
    sd["out_bias"] = _t(p["out_bias"])
    return _contiguous_sd(sd)


def flax_from_longdoc_state_dict(sd: Mapping[str, torch.Tensor],
                                 cfg: Seq2SeqConfig) -> dict:
    """The inverse of ``longdoc_state_dict_from_flax``."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    H, D = cfg.num_heads, cfg.head_dim
    E = H * D
    p = {name: {"embedding": sd[f"{name}.weight"]}
         for name in _LONGDOC_EMBED}
    p["ln"] = _ln_tree(sd, "ln")
    for i in range(cfg.enc_layers):
        pre = f"layers.{i}"
        lp = {name: {
            "kernel": sd[f"{pre}.{name}.weight"].T.reshape(E, H, D),
            "bias": sd[f"{pre}.{name}.bias"].reshape(H, D)}
            for name in ("query", "key", "value")}
        lp["out"] = {"kernel": sd[f"{pre}.out.weight"].T.reshape(H, D, E),
                     "bias": sd[f"{pre}.out.bias"]}
        for name in ("intermediate", "output"):
            lp[name] = {"kernel": sd[f"{pre}.{name}.weight"].T,
                        "bias": sd[f"{pre}.{name}.bias"]}
        for name in ("ln1", "ln2"):
            lp[name] = _ln_tree(sd, f"{pre}.{name}")
        p[f"layers_{i}"] = lp
    p["out_bias"] = sd["out_bias"]
    return {"params": _contiguous_tree(p)}


def random_longdoc_params(cfg: Seq2SeqConfig, seed: int = 0) -> dict:
    """Random flax-layout ``LongDocLM`` params from
    ``numpy.random.RandomState(seed)``, with the JAX model's initializers."""
    rng = np.random.RandomState(seed)
    E, H, D = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    FF = cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape) * cfg.initializer_range).astype(
            np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ln():
        return {"scale": np.ones((E,), np.float32), "bias": zeros(E)}

    p = {"word": {"embedding": normal(cfg.vocab_size, E)},
         "position": {"embedding": normal(cfg.max_position_embeddings, E)},
         "lang": {"embedding": normal(max(1, cfg.num_languages), E)},
         "ln": ln()}
    for i in range(cfg.enc_layers):
        lp = {n: {"kernel": normal(E, H, D), "bias": zeros(H, D)}
              for n in ("query", "key", "value")}
        lp["out"] = {"kernel": normal(H, D, E), "bias": zeros(E)}
        lp["ln1"] = ln()
        lp["intermediate"] = {"kernel": normal(E, FF), "bias": zeros(FF)}
        lp["output"] = {"kernel": normal(FF, E), "bias": zeros(E)}
        lp["ln2"] = ln()
        p[f"layers_{i}"] = lp
    p["out_bias"] = zeros(cfg.vocab_size)
    return {"params": p}


# ---------------- SenSim and Caption2Image ----------------

def _pool_sd(sd, name: str, p: Mapping):
    sd[f"{name}.w.weight"] = _t(p[name]["w"]["kernel"]).T
    sd[f"{name}.w.bias"] = _t(p[name]["w"]["bias"])


def _pool_tree(sd, name: str) -> dict:
    return {"w": {"kernel": sd[f"{name}.w.weight"].T,
                  "bias": sd[f"{name}.w.bias"]}}


def sensim_state_dict_from_flax(params: Mapping, cfg: Seq2SeqConfig
                                ) -> Dict[str, torch.Tensor]:
    """The JAX ``SenSim`` params -> the port's ``SenSim.state_dict()``: the
    ``embeddings`` and ``encoder`` sub-trees as in ``Seq2Seq``, and the
    ``input_attention`` pool."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    _encoder_sd(sd, p, cfg)
    _pool_sd(sd, "input_attention", p)
    return _contiguous_sd(sd)


def flax_from_sensim_state_dict(sd: Mapping[str, torch.Tensor],
                                cfg: Seq2SeqConfig) -> dict:
    """The inverse of ``sensim_state_dict_from_flax``."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    p = _encoder_tree(sd, cfg)
    p["input_attention"] = _pool_tree(sd, "input_attention")
    return {"params": _contiguous_tree(p)}


def random_sensim_params(cfg: Seq2SeqConfig, seed: int = 0) -> dict:
    """Random flax-layout ``SenSim`` params: the text encoder as
    ``random_params`` draws it, the pool's kernel from normal(0.02) of
    ``RandomState(seed + 1)``, a zero bias."""
    p, rng = _random_text_encoder(cfg, seed)
    p["input_attention"] = {"w": {
        "kernel": (rng.standard_normal((cfg.hidden_size, 1))
                   * cfg.initializer_range).astype(np.float32),
        "bias": np.zeros((1,), np.float32)}}
    return {"params": p}


def c2i_state_dict_from_flax(params: Mapping, cfg: Seq2SeqConfig
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``Caption2Image`` params -> the port's state_dict: SenSim's
    keys and the fp32 grid head ``decoder`` (a Dense [E, 49 E])."""
    p = params.get("params", params)
    sd = dict(sensim_state_dict_from_flax(p, cfg))
    sd["decoder.weight"] = _t(p["decoder"]["kernel"]).T.contiguous()
    sd["decoder.bias"] = _t(p["decoder"]["bias"])
    return sd


def flax_from_c2i_state_dict(sd: Mapping[str, torch.Tensor],
                             cfg: Seq2SeqConfig) -> dict:
    """The inverse of ``c2i_state_dict_from_flax``."""
    p = flax_from_sensim_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("decoder.")},
        cfg)["params"]
    p["decoder"] = {"kernel": sd["decoder.weight"].detach().cpu().T
                    .contiguous(), "bias": sd["decoder.bias"].detach().cpu()}
    return {"params": p}


def random_c2i_params(cfg: Seq2SeqConfig, seed: int = 0) -> dict:
    """Random flax-layout ``Caption2Image`` params: ``random_sensim_params``
    and the grid head's kernel from normal(initializer_range), a zero
    bias."""
    p = random_sensim_params(cfg, seed)["params"]
    E = cfg.hidden_size
    rng = np.random.RandomState(seed + 2)
    p["decoder"] = {
        "kernel": (rng.standard_normal((E, 49 * E))
                   * cfg.initializer_range).astype(np.float32),
        "bias": np.zeros((49 * E,), np.float32)}
    return {"params": p}


# ---------------- the captioning model ----------------

_BN = (("scale", "weight"), ("bias", "bias"))
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))


def _resnet_blocks(depth: int):
    """(flax block name, state_dict prefix inside the ResNet) per block."""
    from imagetranslate_tpu_torch.models.resnet import DEPTHS

    for s, blocks in enumerate(DEPTHS[depth][1]):
        for j in range(blocks):
            yield f"layer{s + 1}_{j}", f"layer{s + 1}.{j}"


# A block's flax members and their torchvision names.
_BLOCK_CONVS = (("conv1", "conv1"), ("conv2", "conv2"), ("conv3", "conv3"),
                ("downsample_conv", "downsample.0"))
_BLOCK_BNS = (("bn1", "bn1"), ("bn2", "bn2"), ("bn3", "bn3"),
              ("downsample_bn", "downsample.1"))


def _resnet_sd(sd, pre: str, p: Mapping, stats, depth: int):
    """The ``ResNetGrid`` sub-trees -> torchvision's keys under ``pre``
    (with its dot, or empty):
    flax convolution kernels are HWIO, torch's OIHW; the BatchNorm running
    statistics come from ``stats`` (the ``batch_stats`` collection; None
    leaves them out, as for a parameter-shaped optimizer moment)."""
    def bn(key, bp, bs):
        for theirs, ours in _BN:
            sd[f"{key}.{ours}"] = _t(bp[theirs])
        if bs is not None:
            for theirs, ours in _BN_STATS:
                sd[f"{key}.{ours}"] = _t(bs[theirs])

    def conv(w):
        return _t(w).permute(3, 2, 0, 1)

    sd[f"{pre}conv1.weight"] = conv(p["conv1"]["kernel"])
    bn(f"{pre}bn1", p["bn1"], None if stats is None else stats["bn1"])
    for name, key in _resnet_blocks(depth):
        bp, bs = p[name], None if stats is None else stats[name]
        for theirs, ours in _BLOCK_CONVS:
            if theirs in bp:
                sd[f"{pre}{key}.{ours}.weight"] = conv(bp[theirs]["kernel"])
        for theirs, ours in _BLOCK_BNS:
            if theirs in bp:
                bn(f"{pre}{key}.{ours}", bp[theirs],
                   None if bs is None else bs[theirs])
    if "fc" in p:     # the grid encoder's head; the detector's trunk has none
        sd[f"{pre}fc.weight"] = _t(p["fc"]["kernel"]).T
        sd[f"{pre}location_embedding"] = _t(p["location_embedding"])


def _resnet_trees(sd, pre: str, depth: int):
    """The inverse of ``_resnet_sd``: (params, batch_stats); the statistics
    are empty maps where ``sd`` holds no buffers (a parameter-shaped
    tree)."""
    def bn(key):
        return ({theirs: sd[f"{key}.{ours}"] for theirs, ours in _BN},
                {theirs: sd[f"{key}.{ours}"] for theirs, ours in _BN_STATS
                 if f"{key}.{ours}" in sd})

    def conv(key):
        return {"kernel": sd[f"{key}.weight"].permute(2, 3, 1, 0)}

    p, stats = {"conv1": conv(f"{pre}conv1")}, {}
    p["bn1"], stats["bn1"] = bn(f"{pre}bn1")
    for name, key in _resnet_blocks(depth):
        p[name], stats[name] = {}, {}
        for theirs, ours in _BLOCK_CONVS:
            if f"{pre}{key}.{ours}.weight" in sd:
                p[name][theirs] = conv(f"{pre}{key}.{ours}")
        for theirs, ours in _BLOCK_BNS:
            if f"{pre}{key}.{ours}.weight" in sd:
                p[name][theirs], stats[name][theirs] = bn(
                    f"{pre}{key}.{ours}")
    if f"{pre}fc.weight" in sd:
        p["fc"] = {"kernel": sd[f"{pre}fc.weight"].T}
        p["location_embedding"] = sd[f"{pre}location_embedding"]
    return p, stats


_POOLS = ("image_attention", "encoder_attention")


def _obj_names(cfg: Seq2SeqConfig):
    """(flax suffix, state_dict suffix) of the object decoders and their
    embeddings: bare names for one decoder, numbered under ``lang_dec``."""
    if not cfg.lang_dec:
        return [("", "")]
    return [(f"_{d}", f".{d}") for d in range(cfg.num_languages)]


def caption_state_dict_from_flax(variables: Mapping, cfg: Seq2SeqConfig
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX ``ImageSeq2Seq`` variables (``{"params", "batch_stats"}``) ->
    the port's ``ImageSeq2Seq.state_dict()``: the text model under ``core.``,
    the ResNet under torchvision's names, the running statistics as buffers.
    Without ``batch_stats`` (a parameter-shaped tree) the buffers are left
    out."""
    p = variables.get("params", variables)
    stats = variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {
        f"core.{k}": v for k, v in
        state_dict_from_flax(p["core"], cfg).items()}
    _resnet_sd(sd, "image_model.", p["image_model"],
               None if stats is None else stats["image_model"],
               cfg.resnet_depth)
    sd["multimodal_attention_gate"] = _t(p["multimodal_attention_gate"])
    for name in _POOLS:
        _pool_sd(sd, name, p)
    if cfg.use_obj:
        for theirs, ours in _obj_names(cfg):
            _decoder_sd(sd, f"obj_decoder{ours}", p[f"obj_decoder{theirs}"],
                        cfg)
            _embeddings_sd(sd, f"obj_embeddings{ours}",
                           p[f"obj_embeddings{theirs}"])
        sd["multistream_attention_gate"] = _t(
            p["multistream_attention_gate"])
        sd["object_embedding.weight"] = _t(p["object_embedding"]["embedding"])
        sd["object_feat_fc.weight"] = _t(p["object_feat_fc"]["kernel"]).T
    return _contiguous_sd(sd)


def flax_from_caption_state_dict(sd: Mapping[str, torch.Tensor],
                                 cfg: Seq2SeqConfig) -> dict:
    """The inverse of ``caption_state_dict_from_flax``: the variables
    ``{"params": {...}, "batch_stats": {...}}`` that the JAX package's
    caption checkpoints hold."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    core = {k[len("core."):]: v for k, v in sd.items()
            if k.startswith("core.")}
    p = {"core": flax_from_state_dict(core, cfg)["params"]}
    p["image_model"], stats = _resnet_trees(sd, "image_model.",
                                            cfg.resnet_depth)
    p["multimodal_attention_gate"] = sd["multimodal_attention_gate"]
    for name in _POOLS:
        p[name] = _pool_tree(sd, name)
    if cfg.use_obj:
        for theirs, ours in _obj_names(cfg):
            p[f"obj_decoder{theirs}"] = _decoder_tree(
                sd, f"obj_decoder{ours}", cfg)
            p[f"obj_embeddings{theirs}"] = _embeddings_tree(
                sd, f"obj_embeddings{ours}")
        p["multistream_attention_gate"] = sd["multistream_attention_gate"]
        p["object_embedding"] = {"embedding": sd["object_embedding.weight"]}
        p["object_feat_fc"] = {"kernel": sd["object_feat_fc.weight"].T}
    return {"params": _contiguous_tree(p),
            "batch_stats": _contiguous_tree({"image_model": stats})}


def flax_from_caption_params(sd: Mapping[str, torch.Tensor],
                             cfg: Seq2SeqConfig) -> dict:
    """A parameter-shaped captioner tree (the ``params`` collection alone,
    as the JAX caption trainer's optimizer moments are laid out) from a
    ``state_dict`` without buffers."""
    return flax_from_caption_state_dict(sd, cfg)["params"]


def _random_resnet(rng: np.random.RandomState, depth: int, embed_dim: int,
                   img_size: int):
    """Random flax-layout ``ResNetGrid`` (params, batch_stats) from ``rng``:
    the JAX model's initializers (variance-scaling-normal convolution and
    ``fc`` kernels, unit BatchNorm scales, normal(0.02) location table), and
    running statistics that are not the trivial (0, 1): means from
    normal(0, 0.1), variances from uniform(0.5, 1.5)."""
    from imagetranslate_tpu_torch.models.resnet import DEPTHS

    f32 = np.float32

    def normal(std, *shape):
        return (rng.standard_normal(shape) * std).astype(f32)

    def conv(k, cin, cout, groups=1):
        fan_in = k * k * cin // groups
        return {"kernel": normal(fan_in ** -0.5, k, k, cin // groups, cout)}

    def bn(c):
        return ({"scale": np.ones((c,), f32), "bias": np.zeros((c,), f32)},
                {"mean": normal(0.1, c),
                 "var": rng.uniform(0.5, 1.5, (c,)).astype(f32)})

    kind, stage_sizes, groups, wpg = DEPTHS[depth]
    expansion = 1 if kind == "basic" else 4
    im, st = {"conv1": conv(7, 3, 64)}, {}
    im["bn1"], st["bn1"] = bn(64)
    cin = 64
    for s, blocks in enumerate(stage_sizes):
        for j in range(blocks):
            filters, cout = 64 * 2 ** s, 64 * 2 ** s * expansion
            stride = 2 if s > 0 and j == 0 else 1
            if kind == "basic":
                members = [("1", conv(3, cin, filters), filters),
                           ("2", conv(3, filters, filters), filters)]
            else:
                width = int(filters * (wpg / 64.0)) * groups
                members = [("1", conv(1, cin, width), width),
                           ("2", conv(3, width, width, groups), width),
                           ("3", conv(1, width, cout), cout)]
            bp, bs = {}, {}
            for n, kernel, c in members:
                bp[f"conv{n}"] = kernel
                bp[f"bn{n}"], bs[f"bn{n}"] = bn(c)
            if stride != 1 or cin != cout:
                bp["downsample_conv"] = conv(1, cin, cout)
                bp["downsample_bn"], bs["downsample_bn"] = bn(cout)
            im[f"layer{s + 1}_{j}"], st[f"layer{s + 1}_{j}"] = bp, bs
            cin = cout
    im["fc"] = {"kernel": normal(cin ** -0.5, cin, embed_dim)}
    im["location_embedding"] = normal(0.02, (img_size // 32) ** 2, embed_dim)
    return im, st


def random_resnet_state_dict(depth: int, embed_dim: int, img_size: int = 224,
                             seed: int = 0) -> Dict[str, torch.Tensor]:
    """A random ``ResNetGrid.state_dict()`` drawn as
    ``random_caption_params`` draws the captioner's ResNet."""
    im, st = _random_resnet(np.random.RandomState(seed), depth, embed_dim,
                            img_size)
    sd: Dict[str, torch.Tensor] = {}
    _resnet_sd(sd, "", im, st, depth)
    return _contiguous_sd(sd)


def random_caption_params(cfg: Seq2SeqConfig, seed: int = 0,
                          object_feat_dim: int = 1031) -> dict:
    """Random flax-layout ``ImageSeq2Seq`` variables from
    ``numpy.random.RandomState(seed)``: the text model as ``random_params``
    draws it, the JAX model's initializers for the rest
    (variance-scaling-normal convolution and ``fc`` kernels, unit BatchNorm
    scales, normal(0.02) location table, 0.1 gates), and running statistics
    that are not the trivial (0, 1): means from normal(0, 0.1), variances
    from uniform(0.5, 1.5). fp32 numpy leaves."""
    rng = np.random.RandomState(seed + 1)
    E = cfg.hidden_size
    f32 = np.float32

    def normal(std, *shape):
        return (rng.standard_normal(shape) * std).astype(f32)

    im, st = _random_resnet(rng, cfg.resnet_depth, E, cfg.img_size)
    core = random_params(cfg, seed)["params"]
    p = {"core": core, "image_model": im,
         "multimodal_attention_gate": np.full((1, E), 0.1, f32)}
    std = cfg.initializer_range
    for name in _POOLS:
        p[name] = {"w": {"kernel": normal(std, E, 1),
                         "bias": np.zeros((1,), f32)}}
    if cfg.use_obj:
        # One more decoder stack and embedding table per decoder head, drawn
        # as the text model's are.
        extra = random_params(cfg, seed + 2)["params"]
        for d, (theirs, _) in enumerate(_obj_names(cfg)):
            p[f"obj_decoder{theirs}"] = extra[f"decoders_{d}"]
            p[f"obj_embeddings{theirs}"] = copy.deepcopy(extra["embeddings"])
        p["multistream_attention_gate"] = np.full((1, E), 0.1, f32)
        p["object_embedding"] = {"embedding": normal(std, 91, E)}
        p["object_feat_fc"] = {"kernel": normal(std, object_feat_dim, E)}
    return {"params": p, "batch_stats": {"image_model": st}}


# ---------------- the Faster R-CNN detector ----------------

_FRCNN_CONVS = (("lateral_{}", "backbone.fpn.inner_blocks.{}"),
                ("out_{}", "backbone.fpn.layer_blocks.{}"))
_FRCNN_RPN = ("conv", "cls_logits", "bbox_pred")     # under rpn.head.
_FRCNN_DENSE = (("fc7", "roi_heads.box_head.fc7"),
                ("cls_score", "roi_heads.box_predictor.cls_score"),
                ("bbox_pred", "roi_heads.box_predictor.bbox_pred"))
_FC6 = "roi_heads.box_head.fc6"


def _conv_b_sd(sd, key: str, p: Mapping):
    sd[f"{key}.weight"] = _t(p["kernel"]).permute(3, 2, 0, 1)
    sd[f"{key}.bias"] = _t(p["bias"])


def _conv_b_tree(sd, key: str) -> dict:
    return {"kernel": sd[f"{key}.weight"].permute(2, 3, 1, 0),
            "bias": sd[f"{key}.bias"]}


def detector_state_dict_from_flax(variables: Mapping, cfg=None
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX ``FasterRCNN`` variables (what
    ``train.torch_import.import_torchvision_frcnn`` makes) -> the port's
    ``FasterRCNN.state_dict()``, torchvision's keys and layouts: fc6 takes
    its input in (C, H, W) order again. ``cfg`` is unused (the detector has
    one shape)."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _resnet_sd(sd, "backbone.body.", p["backbone"], stats["backbone"], 3)
    for i in range(4):
        for theirs, ours in _FRCNN_CONVS:
            _conv_b_sd(sd, ours.format(i), p["fpn"][theirs.format(i)])
    for name in _FRCNN_RPN:
        _conv_b_sd(sd, f"rpn.head.{name}", p["rpn"][name])
    bh = p["box_head"]
    w6 = _t(bh["fc6"]["kernel"]).T                    # [1024, (H, W, C)]
    sd[f"{_FC6}.weight"] = w6.reshape(-1, 7, 7, 256).permute(
        0, 3, 1, 2).reshape(w6.shape[0], -1)
    sd[f"{_FC6}.bias"] = _t(bh["fc6"]["bias"])
    for theirs, ours in _FRCNN_DENSE:
        sd[f"{ours}.weight"] = _t(bh[theirs]["kernel"]).T
        sd[f"{ours}.bias"] = _t(bh[theirs]["bias"])
    return _contiguous_sd(sd)


def flax_from_detector_state_dict(sd: Mapping[str, torch.Tensor], cfg=None
                                  ) -> dict:
    """The inverse of ``detector_state_dict_from_flax``: the variables that
    ``import_torchvision_frcnn`` makes of the same torchvision state_dict."""
    sd = {k: _t(v).detach().cpu() for k, v in sd.items()}
    body, stats = _resnet_trees(sd, "backbone.body.", 3)
    fpn = {theirs.format(i): _conv_b_tree(sd, ours.format(i))
           for i in range(4) for theirs, ours in _FRCNN_CONVS}
    rpn = {name: _conv_b_tree(sd, f"rpn.head.{name}") for name in _FRCNN_RPN}
    w6 = sd[f"{_FC6}.weight"]
    w6 = w6.reshape(-1, 256, 7, 7).permute(0, 2, 3, 1).reshape(
        w6.shape[0], -1)
    box_head = {"fc6": {"kernel": w6.T, "bias": sd[f"{_FC6}.bias"]}}
    for theirs, ours in _FRCNN_DENSE:
        box_head[theirs] = {"kernel": sd[f"{ours}.weight"].T,
                            "bias": sd[f"{ours}.bias"]}
    return {"params": _contiguous_tree({"backbone": body, "fpn": fpn,
                                        "rpn": rpn, "box_head": box_head}),
            "batch_stats": _contiguous_tree({"backbone": stats})}


def _detector_keys():
    from imagetranslate_tpu_torch.models.detector import FasterRCNN

    return set(FasterRCNN(device="meta").state_dict())


def load_torchvision_frcnn(sd) -> Dict[str, torch.Tensor]:
    """A torchvision ``fasterrcnn_resnet50_fpn`` checkpoint -> the port's
    ``FasterRCNN`` state_dict (fp32). Takes a module or anything with
    ``state_dict()``, a ``{"model": state_dict}`` wrapper or the state_dict
    itself; reads both spellings torchvision has used
    (``backbone.fpn.inner_blocks.i`` / ``inner_blocks.i.0``,
    ``rpn.head.conv`` / ``rpn.head.conv.0.0``); ignores
    ``num_batches_tracked`` and keys the detector does not have. A missing
    key raises ``KeyError``."""
    import re

    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    renamed = {}
    for k, v in sd.items():
        if not hasattr(v, "numpy"):
            continue
        k = re.sub(r"^(backbone\.fpn\.(?:inner|layer)_blocks\.\d+)\.0\.",
                   r"\1.", k)
        k = re.sub(r"^rpn\.head\.conv\.0\.0\.", "rpn.head.conv.", k)
        renamed[k] = v
    keys = _detector_keys()
    missing = sorted(keys - set(renamed))
    if missing:
        raise KeyError(f"not a fasterrcnn_resnet50_fpn state_dict: missing "
                       f"{missing[:4]}{' ...' if len(missing) > 4 else ''}")
    return {k: torch.as_tensor(renamed[k]).to(torch.float32).contiguous()
            for k in sorted(keys)}


def random_frcnn_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A random ``fasterrcnn_resnet50_fpn`` state_dict in torchvision's
    layout, from ``numpy.random.RandomState(seed)``: He-normal convolutions,
    BatchNorm affine terms near (1, 0), small objectness and box-delta
    weights (unsaturated logits, boxes that stay boxes), and class-score
    biases spread by 1.0 so that some detections clear the 0.05 score.
    The BatchNorm running statistics are then calibrated on the CPU to the
    true statistics of a random 128 x 128 image (+1e-3 on the variance), as
    trained ones would be: random statistics let the activations grow ~4x
    a stage through the residual sums, and every box collapses."""
    from imagetranslate_tpu_torch.models.detector import (
        ANCHOR_RATIOS,
        NUM_CLASSES,
        FasterRCNN,
    )
    from imagetranslate_tpu_torch.models.resnet import BatchNorm2d

    rs = np.random.RandomState(seed)
    f32 = np.float32
    sd: Dict[str, np.ndarray] = {}

    def conv(key, co, ci, k, scale=1.0, bias=True):
        sd[f"{key}.weight"] = (rs.randn(co, ci, k, k)
                               * np.sqrt(2.0 / (ci * k * k)) * scale
                               ).astype(f32)
        if bias:
            sd[f"{key}.bias"] = (rs.randn(co) * 0.01).astype(f32)

    def bn(key, c, gamma=1.0):
        sd[f"{key}.weight"] = (gamma * (1.0 + 0.1 * rs.randn(c))).astype(f32)
        sd[f"{key}.bias"] = (0.1 * rs.randn(c)).astype(f32)
        sd[f"{key}.running_mean"] = np.zeros(c, f32)
        sd[f"{key}.running_var"] = np.ones(c, f32)

    def dense(key, co, ci, w_scale=1.0, b_scale=0.01):
        sd[f"{key}.weight"] = (rs.randn(co, ci) * np.sqrt(1.0 / ci)
                               * w_scale).astype(f32)
        sd[f"{key}.bias"] = (rs.randn(co) * b_scale).astype(f32)

    conv("backbone.body.conv1", 64, 3, 7, bias=False)
    bn("backbone.body.bn1", 64)
    cin = 64
    for s, blocks in enumerate((3, 4, 6, 3)):
        width = 64 * 2 ** s
        for j in range(blocks):
            t = f"backbone.body.layer{s + 1}.{j}"
            conv(f"{t}.conv1", width, cin, 1, bias=False)
            bn(f"{t}.bn1", width)
            conv(f"{t}.conv2", width, width, 3, bias=False)
            bn(f"{t}.bn2", width)
            conv(f"{t}.conv3", width * 4, width, 1, bias=False)
            bn(f"{t}.bn3", width * 4, gamma=0.2)
            if j == 0:
                conv(f"{t}.downsample.0", width * 4, cin, 1, bias=False)
                bn(f"{t}.downsample.1", width * 4)
            cin = width * 4
    lin = np.sqrt(0.5)          # fan-in scaling where no ReLU precedes
    for i, c in enumerate((256, 512, 1024, 2048)):
        conv(f"backbone.fpn.inner_blocks.{i}", 256, c, 1, scale=lin)
        conv(f"backbone.fpn.layer_blocks.{i}", 256, 256, 3, scale=lin)
    A = len(ANCHOR_RATIOS)
    conv("rpn.head.conv", 256, 256, 3, scale=lin)
    conv("rpn.head.cls_logits", A, 256, 1, scale=0.02)
    conv("rpn.head.bbox_pred", A * 4, 256, 1, scale=0.05)
    dense("roi_heads.box_head.fc6", 1024, 256 * 49)
    dense("roi_heads.box_head.fc7", 1024, 1024)
    dense("roi_heads.box_predictor.cls_score", NUM_CLASSES, 1024, b_scale=1.0)
    dense("roi_heads.box_predictor.bbox_pred", NUM_CLASSES * 4, 1024,
          w_scale=0.05)

    model = FasterRCNN(device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})

    def calibrate(module, args):
        x = args[0].to(torch.float32)
        module.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        module.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False) + 1e-3)

    hooks = [m.register_forward_pre_hook(calibrate)
             for m in model.modules() if isinstance(m, BatchNorm2d)]
    image = np.random.RandomState(seed + 7).randn(1, 3, 128, 128).astype(f32)
    try:
        with torch.no_grad():
            model.backbone["body"](torch.from_numpy(image))
    finally:
        for h in hooks:
            h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def random_detector_params(seed: int = 0) -> dict:
    """``random_frcnn_state_dict(seed)`` as the JAX module's variables."""
    return flax_from_detector_state_dict(random_frcnn_state_dict(seed))


class Bridge(NamedTuple):
    """How one model's weights cross between the flax tree and the port's
    ``state_dict``, and how they are drawn at random."""

    state_dict_from_flax: Callable
    flax_from_state_dict: Callable
    random_params: Callable


SEQ2SEQ = Bridge(state_dict_from_flax, flax_from_state_dict, random_params)
LM = Bridge(lm_state_dict_from_flax, flax_from_lm_state_dict,
            random_lm_params)
LONGDOC = Bridge(longdoc_state_dict_from_flax, flax_from_longdoc_state_dict,
                 random_longdoc_params)
SENSIM = Bridge(sensim_state_dict_from_flax, flax_from_sensim_state_dict,
                random_sensim_params)
CAPTION2IMAGE = Bridge(c2i_state_dict_from_flax, flax_from_c2i_state_dict,
                       random_c2i_params)
CAPTION = Bridge(caption_state_dict_from_flax, flax_from_caption_state_dict,
                 random_caption_params)
# The caption trainer's optimizer state: its moments are trees of the
# ``params`` collection alone (no ``batch_stats``, no ``{"params": ...}``
# wrapper).
CAPTION_PARAMS = Bridge(caption_state_dict_from_flax,
                        flax_from_caption_params, random_caption_params)
DETECTOR = Bridge(detector_state_dict_from_flax, flax_from_detector_state_dict,
                  random_detector_params)


def _count(n: int) -> torch.Tensor:
    return torch.tensor(int(n), dtype=torch.int32)


def flax_from_opt_state(opt_state: AnyOptState, optimizer: Optimizer,
                        cfg: Seq2SeqConfig, bridge: Bridge = SEQ2SEQ) -> dict:
    """The port's optimizer state -> the optax state tree as flax writes it
    (``checkpoint.save_checkpoint`` takes it as ``opt_state``). ``bridge``:
    the model's (its moments are parameter-shaped)."""
    def tree(sd):
        return bridge.flax_from_state_dict(sd, cfg)

    if isinstance(opt_state, MultiStepsState):
        return {"mini_step": _count(opt_state.mini_step),
                "gradient_step": _count(opt_state.gradient_step),
                "inner_opt_state": flax_from_opt_state(
                    opt_state.inner_opt_state, optimizer.inner, cfg, bridge),
                "acc_grads": tree(opt_state.acc_grads),
                "skip_state": {}}
    out = {}
    for i, member in enumerate(optimizer.chain):
        if member == "adam":
            out[str(i)] = {"count": _count(opt_state.count),
                           "mu": tree(opt_state.mu), "nu": tree(opt_state.nu)}
        elif member == "schedule":
            out[str(i)] = {"count": _count(opt_state.schedule_count)}
        else:
            out[str(i)] = {}
    return out


def opt_state_from_flax(tree: Mapping, optimizer: Optimizer,
                        cfg: Seq2SeqConfig, device=None,
                        bridge: Bridge = SEQ2SEQ) -> AnyOptState:
    """The optax state tree (``checkpoint.load_checkpoint``'s second result)
    -> the port's optimizer state for ``optimizer``, tensors on ``device``.
    The tree must have the optimizer's layout (same chain, same
    accumulation)."""
    def sd(sub):
        return {k: v.to(device) for k, v in
                bridge.state_dict_from_flax(sub, cfg).items()}

    if isinstance(optimizer, MultiSteps) != ("inner_opt_state" in tree):
        raise ValueError("the saved optimizer state and the optimizer differ "
                         "in gradient accumulation (MultiSteps)")
    if isinstance(optimizer, MultiSteps):
        return MultiStepsState(
            int(tree["mini_step"]), int(tree["gradient_step"]),
            opt_state_from_flax(tree["inner_opt_state"], optimizer.inner, cfg,
                                device, bridge),
            sd(tree["acc_grads"]))
    if len(tree) != len(optimizer.chain):
        raise ValueError(f"the saved optimizer chain has {len(tree)} members, "
                         f"the optimizer {len(optimizer.chain)}")
    adam = tree[str(optimizer.chain.index("adam"))]
    sched = tree[str(optimizer.chain.index("schedule"))]
    return OptState(int(adam["count"]), sd(adam["mu"]), sd(adam["nu"]),
                    int(sched["count"]))
