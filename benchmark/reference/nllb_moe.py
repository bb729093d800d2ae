"""NLLB-MoE's encoder-decoder at inference in plain PyTorch, fp32: the
reference that the ``nllb-moe-*`` cells and the port's CPU tests hold the
program against.

The equations are those of Hugging Face's ``modeling_nllb_moe.py``
(``NllbMoeForConditionalGeneration`` in eval mode; the NLLB Team, "No
Language Left Behind", arXiv:2207.04672):

- embedding: x = E[ids] * sqrt(d) + P[pos], P fairseq's sinusoid (half =
  d / 2, f_i = exp(-i ln(10000) / (half - 1)), row p = [sin(p f), cos(p f)],
  row ``pad_id`` zero); a source token's position is ``pad_id`` + its rank
  among its row's real tokens, a decoder input's ``pad_id`` + 1 + its step;
  no LayerNorm and no language row;
- encoder layer: h = x + Attn(LN1(x)); y = h + FFN(LN2(h)); decoder layer:
  h1 = x + SelfAttn_causal(LN1(x)); h2 = h1 + CrossAttn(LN2(h1), enc);
  y = h2 + FFN(LN3(h2)); each stack ends in a final LayerNorm;
- attention: q, k, v and out projections with biases, q scaled by D^-1/2;
- dense FFN: fc2(relu(fc1 x)), with biases;
- MoE FFN in layer i where (i + 1) % ``moe_every`` == 0: p = softmax(x W_r)
  in fp32 without a bias; for each token its top-k experts by argmax (the
  first max), each chosen again masked out; g_j = p[e_j] / sum of the chosen
  p; no capacity, so no choice is dropped; y = sum_j g_j *
  ``moe_inference_scale`` * Expert_{e_j}(x), each expert a dense ReLU FFN
  with biases (HF's ``NllbMoeSparseMLP`` scales by 1 - ``moe_token_dropout``
  at inference); padding tokens are routed like any other token;
- output: logits = y_dec E^T, tied to the shared embedding, no bias.

Departures, each named: the weights are a dict keyed by the port's
``state_dict`` names (``encoder.encoder.layer.{i}.attention.self.query``,
``...moe.wi`` [E, H, F], the final LayerNorms as
``{encoder,decoder}.{encoder,decoder}.LayerNorm``); the pre-norm of a block
is the port's ``output.LayerNorm`` (an MoE bank's ``moe.ln``); masks add
-10000 where HF adds the dtype's least value (the same softmax wherever a
row keeps a key); routing runs a loop over the experts, each taking the
tokens that chose it, in place of HF's dispatch mask. ``prec`` (``FP32`` or
the control's ``FP8``) computes every product but the router's, which the
configuration states in fp32.

Replayed routing (``routes``): at the published widths an expert's output
is as large as the residual it joins, and among 128 experts the second and
third router logits of a token often lie closer than bfloat16's rounding of
the router's input moves them, so a sound bf16 program and the fp32
reference pick different experts for a few tokens and their logits part by
far more than rounding. Where ``routes`` holds a layer's choices (the
program's, a token's experts [k, tokens], -1 where none is given), each
token takes the given experts, with the gates of the reference's own fp32
router, and ``route_excess`` keeps by how much, in router logits, an expert
left out beats one taken: 0 where the given choice is the reference's own,
near 0 for a near tie broken the other way, large for a wrong choice.
``recorded`` (a dict, when set) receives each layer's own choices.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference.model import bias_from_keep, layer_norm
from reference.precision import FP32


def sinusoid(n: int, dim: int, pad_id: int, device=None) -> torch.Tensor:
    half = dim // 2
    f = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                  * -(math.log(10000.0) / (half - 1)))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * f
    table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    table[pad_id] = 0.0
    return table


class NllbMoeRef:
    """``W``: name -> fp32 tensor; ``cfg``: the configuration's keys
    (``hidden_size``, ``num_heads``, ``intermediate_size``, ``enc_layers``,
    ``dec_layers``, ``moe_experts``, ``moe_top_k``, ``moe_every``,
    ``moe_inference_scale``, ``pad_id``, ``layer_norm_eps``,
    ``max_position_embeddings``)."""

    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict, prec=FP32):
        self.W, self.cfg, self.prec = W, cfg, prec
        self.E = cfg["hidden_size"]
        self.H = cfg["num_heads"]
        self.D = self.E // self.H
        self.eps = cfg["layer_norm_eps"]
        self.pad = cfg["pad_id"]
        self.routes: Dict[str, torch.Tensor] = {}
        self.recorded = None
        self.route_excess = 0.0
        word = W["encoder.embeddings.word_embeddings.weight"]
        self.table = sinusoid(cfg["max_position_embeddings"] + self.pad + 1,
                              self.E, self.pad, word.device)

    def is_moe(self, i: int) -> bool:
        return (self.cfg["moe_experts"] > 0
                and (i + 1) % self.cfg["moe_every"] == 0)

    def linear(self, x, name):
        return self.prec.linear(x, self.W[name + ".weight"],
                                self.W[name + ".bias"])

    def ln(self, x, name):
        return layer_norm(x, self.W, name, self.eps)

    def embed(self, ids, pos):
        word = self.W["encoder.embeddings.word_embeddings.weight"]
        return word[ids] * math.sqrt(self.E) + self.table[pos]

    def attention(self, x, kv, bias, name):
        """Attention of x's queries over kv (both normalised), without the
        residual."""
        B, T, _ = x.shape
        S = kv.shape[1]
        H, D = self.H, self.D
        q = self.linear(x, name + ".self.query").view(B, T, H, D)
        k = self.linear(kv, name + ".self.key").view(B, S, H, D)
        v = self.linear(kv, name + ".self.value").view(B, S, H, D)
        scores = self.prec.matmul(q.permute(0, 2, 1, 3) / math.sqrt(D),
                                  k.permute(0, 2, 3, 1)) + bias
        probs = torch.softmax(scores, dim=-1)
        ctx = self.prec.matmul(probs, v.permute(0, 2, 1, 3))
        return self.linear(ctx.permute(0, 2, 1, 3).reshape(B, T, self.E),
                           name + ".output.dense")

    def ffn(self, x, name):
        """The dense FFN on the normalised x, without the residual."""
        h = F.relu(self.linear(x, name + ".intermediate.dense"))
        return self.linear(h, name + ".output.dense")

    def moe(self, x, name):
        """The MoE FFN on the normalised x [..., E]: per-token top-k routing
        (or the replayed ``routes``) and a loop over the experts, with no
        capacity."""
        W, cfg = self.W, self.cfg
        p, k = name + ".moe.", cfg["moe_top_k"]
        tokens = x.reshape(-1, self.E)
        logits = tokens @ W[p + "router.weight"].t()
        probs = torch.softmax(logits, dim=-1)
        remaining = probs.clone()
        chosen = []
        for _ in range(k):
            e = torch.argmax(remaining, dim=-1)
            chosen.append(e)
            remaining.scatter_(1, e[:, None], -1.0)
        if self.recorded is not None:
            self.recorded[name] = torch.stack(chosen).reshape(
                k, *x.shape[:-1])
        given = self.routes.get(name)
        if given is not None:
            given = given.reshape(k, -1).to(logits.device)
            have = (given >= 0).all(dim=0)
            chosen = [torch.where(have, g, c) for g, c in zip(given, chosen)]
            pick = torch.stack(chosen, dim=1)
            left = logits.scatter(1, pick, float("-inf")).max(dim=1).values
            excess = (left - logits.gather(1, pick).min(dim=1).values)
            if have.any():
                self.route_excess = max(self.route_excess, float(
                    excess[have].clamp(min=0.0).max()))
        gates = [probs.gather(1, e[:, None])[:, 0] for e in chosen]
        total = sum(gates)
        out = torch.zeros_like(tokens)
        for e in range(cfg["moe_experts"]):
            for idx, g in zip(chosen, gates):
                rows = (idx == e).nonzero()[:, 0]
                if rows.numel() == 0:
                    continue
                h = F.relu(self.prec.matmul(tokens[rows], W[p + "wi"][e])
                           + W[p + "bi"][e])
                y = self.prec.matmul(h, W[p + "wo"][e]) + W[p + "bo"][e]
                weight = g[rows] / total[rows] * cfg["moe_inference_scale"]
                out.index_add_(0, rows, weight[:, None] * y)
        return out.reshape(x.shape)

    def block_ffn(self, x, name, i):
        if self.is_moe(i):
            return x + self.moe(self.ln(x, name + ".moe.ln"), name)
        return x + self.ffn(self.ln(x, name + ".output.LayerNorm"), name)

    def encode(self, src, keep):
        """src [B, S] ids, keep [B, S] (True at a real token) -> the final
        encoder states [B, S, E]."""
        k = keep.to(torch.long)
        x = self.embed(src, self.pad + torch.cumsum(k, dim=1) * k)
        bias = bias_from_keep(keep[:, None, None, :])
        for i in range(self.cfg["enc_layers"]):
            p = f"encoder.encoder.layer.{i}"
            a = p + ".attention"
            h = self.ln(x, a + ".output.LayerNorm")
            x = x + self.attention(h, h, bias, a)
            x = self.block_ffn(x, p, i)
        return self.ln(x, "encoder.encoder.LayerNorm")

    def decode(self, enc, tgt_in, tgt_pos, tgt_langs, self_keep, cross_keep):
        """Teacher-forced decoder states [B, T, E] over the input tokens
        ``tgt_in`` [B, T] at steps ``tgt_pos`` (0, 1, ...); ``tgt_langs`` is
        unread (NLLB marks languages with tokens); ``self_keep``
        [B, 1, T, T], ``cross_keep`` [B, 1, 1, S]: the signature of
        ``reference/model.py``'s ``decode``, which
        ``reference/decode.py::teacher_forced_logits`` calls."""
        x = self.embed(tgt_in, self.pad + 1 + tgt_pos)
        sb, cb = bias_from_keep(self_keep), bias_from_keep(cross_keep)
        for i in range(self.cfg["dec_layers"]):
            p = f"decoder.decoder.layer.{i}"
            a, c = p + ".attention", p + ".crossattention"
            h = self.ln(x, a + ".output.LayerNorm")
            x = x + self.attention(h, h, sb, a)
            h = self.ln(x, c + ".output.LayerNorm")
            x = x + self.attention(h, enc, cb, c)
            x = self.block_ffn(x, p, i)
        return self.ln(x, "decoder.decoder.LayerNorm")

    def project(self, hidden):
        """Logits over the vocabulary: tied to the shared embedding, no
        bias."""
        return self.prec.matmul(
            hidden, self.W["encoder.embeddings.word_embeddings.weight"].t())
