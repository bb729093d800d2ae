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
"""

from __future__ import annotations

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
    for name in ("query", "key", "value"):
        sd[f"{prefix}.self.{name}.weight"] = _t(p[name]["kernel"]).reshape(
            E, E).T
        sd[f"{prefix}.self.{name}.bias"] = _t(p[name]["bias"]).reshape(E)
    sd[f"{prefix}.output.dense.weight"] = _t(p["out"]["kernel"]).reshape(
        E, E).T
    sd[f"{prefix}.output.dense.bias"] = _t(p["out"]["bias"])
    sd[f"{prefix}.output.LayerNorm.weight"] = _t(p["ln"]["scale"])
    sd[f"{prefix}.output.LayerNorm.bias"] = _t(p["ln"]["bias"])


def _ffn(sd, prefix: str, p: Mapping):
    for name in ("intermediate", "output"):
        sd[f"{prefix}.{name}.dense.weight"] = _t(p[name]["kernel"]).T
        sd[f"{prefix}.{name}.dense.bias"] = _t(p[name]["bias"])
    sd[f"{prefix}.output.LayerNorm.weight"] = _t(p["ln"]["scale"])
    sd[f"{prefix}.output.LayerNorm.bias"] = _t(p["ln"]["bias"])


def _encoder_sd(sd, p: Mapping, cfg: Seq2SeqConfig):
    """The ``embeddings`` and ``encoder`` sub-trees (those of ``Seq2Seq`` and
    of ``LM``) -> the ``encoder.*`` keys."""
    E = cfg.hidden_size
    emb, ep = "encoder.embeddings", p["embeddings"]
    sd[f"{emb}.word_embeddings.weight"] = _t(ep["word"]["embedding"])
    sd[f"{emb}.position_embeddings.weight"] = _t(ep["position"]["embedding"])
    sd[f"{emb}.token_type_embeddings.weight"] = _t(ep["lang"]["embedding"])
    sd[f"{emb}.LayerNorm.weight"] = _t(ep["ln"]["scale"])
    sd[f"{emb}.LayerNorm.bias"] = _t(ep["ln"]["bias"])

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
    E = cfg.hidden_size
    sd: Dict[str, torch.Tensor] = {}
    _encoder_sd(sd, p, cfg)

    n_dec = cfg.num_languages if cfg.lang_dec else 1
    for d in range(n_dec):
        dec = f"decoder.{d}" if cfg.lang_dec else "decoder"
        out = f"output_layer.{d}.layer" if cfg.lang_dec else "output_layer.layer"
        for i in range(cfg.dec_layers):
            lp = p[f"decoders_{d}"][f"layers_{i}"]
            pre = f"{dec}.decoder.layer.{i}"
            _attn(sd, f"{pre}.attention", lp["self_attn"], E)
            _attn(sd, f"{pre}.crossattention", lp["cross_attn"], E)
            _ffn(sd, pre, lp["ffn"])
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
    tree = {name: {"kernel": sd[f"{prefix}.{name}.dense.weight"].T,
                   "bias": sd[f"{prefix}.{name}.dense.bias"]}
            for name in ("intermediate", "output")}
    tree["ln"] = _ln_tree(sd, f"{prefix}.output.LayerNorm")
    return tree


def _ln_tree(sd, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _encoder_tree(sd, cfg: Seq2SeqConfig) -> dict:
    """The ``encoder.*`` keys -> the ``embeddings`` and ``encoder``
    sub-trees."""
    H, D = cfg.num_heads, cfg.head_dim
    emb = "encoder.embeddings"
    p = {"embeddings": {
        "word": {"embedding": sd[f"{emb}.word_embeddings.weight"]},
        "position": {"embedding": sd[f"{emb}.position_embeddings.weight"]},
        "lang": {"embedding": sd[f"{emb}.token_type_embeddings.weight"]},
        "ln": _ln_tree(sd, f"{emb}.LayerNorm")}}
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
    H, D = cfg.num_heads, cfg.head_dim
    p = _encoder_tree(sd, cfg)
    n_dec = cfg.num_languages if cfg.lang_dec else 1
    for d in range(n_dec):
        dec = f"decoder.{d}" if cfg.lang_dec else "decoder"
        out = f"output_layer.{d}.layer" if cfg.lang_dec else "output_layer.layer"
        p[f"decoders_{d}"] = {}
        for i in range(cfg.dec_layers):
            pre = f"{dec}.decoder.layer.{i}"
            p[f"decoders_{d}"][f"layers_{i}"] = {
                "self_attn": _attn_tree(sd, f"{pre}.attention", H, D),
                "cross_attn": _attn_tree(sd, f"{pre}.crossattention", H, D),
                "ffn": _ffn_tree(sd, pre)}
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
    normal(initializer_range) for kernels and embeddings, zero biases, unit
    LayerNorm scales, a 0.1 proposal gate. fp32 numpy leaves."""
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


def random_lm_params(cfg: Seq2SeqConfig, seed: int = 0) -> dict:
    """Random flax-layout ``LM`` params: the embeddings and the encoder that
    ``random_params`` draws from the same seed, and a zero ``out_bias``."""
    p = random_params(dataclasses.replace(
        cfg, dec_layers=0, tie_embed=True, lang_dec=False,
        use_proposals=False), seed)["params"]
    return {"params": {"embeddings": p["embeddings"],
                       "encoder": p["encoder"], "out_bias": p["out_bias_0"]}}


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
