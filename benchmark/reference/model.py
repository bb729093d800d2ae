"""The encoder-decoder translation model in plain PyTorch, fp32.

BERT-style post-LayerNorm blocks (HF ``transformers`` 2.9 BertModel, which
the reference repository builds its encoder and decoder from): word +
position + language (token-type) embeddings, LayerNorm, dropout; each layer
multi-head attention with an additive -10000 mask, softmax, dropout on the
probabilities, the output projection, dropout, a residual LayerNorm; the
decoder's layers add cross-attention over the encoder states; the FFN is
dense, exact gelu, dense, dropout, residual LayerNorm. The decoder shares the
encoder's embeddings; a Linear with bias projects onto the vocabulary.

Weights are a dict keyed by the HF-2.9 state_dict names (``W``). ``prec``
(``precision.FP32`` or a lower precision for the control) computes every
product. ``drop`` (``DropoutStream``) turns dropout on; None is inference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from reference.philox import keep_mask
from reference.precision import FP32

NEG = -10000.0


class DropoutStream:
    """The dropout of one training forward, drawn as the configuration's
    training step documents it: a seed for a device generator first, then
    one seed per attention call for its Philox keep-mask, all from a host
    ``torch.Generator``, in the order of the forward pass; elementwise masks
    (``rand >= rate``) from the device generator in the same order."""

    def __init__(self, host: torch.Generator, device, rate: float,
                 attn_rate: float):
        self.host, self.rate, self.attn_rate = host, rate, attn_rate
        self.dev = torch.Generator(device=device)
        self.dev.manual_seed(self.next_seed())

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.host))

    def elementwise(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.dev,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

    def attention(self, B: int, H: int, T: int, S: int, device):
        return keep_mask(self.attn_rate, self.next_seed(), B, H, T, S, device)


def bias_from_keep(keep: torch.Tensor) -> torch.Tensor:
    return (1.0 - keep.to(torch.float32)) * NEG


def segment_keep(seg_q, seg_k, causal: bool = False):
    """[B, Tq] x [B, Tk] segment ids (0 = padding) -> keep [B, 1, Tq, Tk]."""
    keep = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_k[:, None, :] > 0)
    if causal:
        T = seg_q.shape[1]
        keep = keep & torch.tril(torch.ones((T, T), dtype=torch.bool,
                                            device=seg_q.device))[None]
    return keep[:, None]


def layer_norm(x, W, name, eps):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"],
                        W[name + ".bias"], eps)


class Seq2SeqRef:
    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict, prec=FP32):
        self.W, self.cfg, self.prec = W, cfg, prec
        self.H = cfg["num_heads"]
        self.D = cfg["hidden_size"] // self.H
        self.eps = cfg["layer_norm_eps"]

    def linear(self, x, name, bias: bool = True):
        W = self.W
        return self.prec.linear(x, W[name + ".weight"],
                                W[name + ".bias"] if bias else None)

    def embed(self, ids, pos, langs, drop: Optional[DropoutStream]):
        W, p = self.W, "encoder.embeddings."
        x = (W[p + "word_embeddings.weight"][ids]
             + W[p + "position_embeddings.weight"][pos]
             + W[p + "token_type_embeddings.weight"][langs])
        x = layer_norm(x, W, p + "LayerNorm", self.eps)
        return x if drop is None else drop.elementwise(x)

    def attention(self, x, kv, bias, name, drop):
        B, T, E = x.shape
        S = kv.shape[1]
        H, D = self.H, self.D
        q = self.linear(x, name + ".self.query").view(B, T, H, D)
        k = self.linear(kv, name + ".self.key").view(B, S, H, D)
        v = self.linear(kv, name + ".self.value").view(B, S, H, D)
        scale = 1.0 / math.sqrt(D)
        scores = self.prec.matmul(q.permute(0, 2, 1, 3),
                                  k.permute(0, 2, 3, 1)) * scale + bias
        probs = torch.softmax(scores, dim=-1)
        if drop is not None:
            keep = drop.attention(B, H, T, S, x.device)
            probs = torch.where(keep, probs / (1.0 - drop.attn_rate), 0.0)
        ctx = self.prec.matmul(probs, v.permute(0, 2, 1, 3))
        out = self.linear(ctx.permute(0, 2, 1, 3).reshape(B, T, E),
                          name + ".output.dense")
        if drop is not None:
            out = drop.elementwise(out)
        return layer_norm(out + x, self.W, name + ".output.LayerNorm",
                          self.eps)

    def ffn(self, x, name, drop):
        h = F.gelu(self.linear(x, name + ".intermediate.dense"))
        out = self.linear(h, name + ".output.dense")
        if drop is not None:
            out = drop.elementwise(out)
        return layer_norm(out + x, self.W, name + ".output.LayerNorm",
                          self.eps)

    def encode(self, src, src_pos, src_langs, enc_keep, drop=None):
        """src, src_pos, src_langs [B, S] ids; enc_keep [B, 1, S|1, S]."""
        x = self.embed(src, src_pos, src_langs, drop)
        bias = bias_from_keep(enc_keep)
        for i in range(self.cfg["enc_layers"]):
            p = f"encoder.encoder.layer.{i}"
            x = self.attention(x, x, bias, p + ".attention", drop)
            x = self.ffn(x, p, drop)
        return x

    def decode(self, enc, tgt_in, tgt_pos, tgt_langs, self_keep, cross_keep,
               drop=None):
        """Teacher-forced decoder states [B, T, E] over the input tokens
        ``tgt_in`` [B, T]."""
        x = self.embed(tgt_in, tgt_pos, tgt_langs, drop)
        sb, cb = bias_from_keep(self_keep), bias_from_keep(cross_keep)
        for i in range(self.cfg["dec_layers"]):
            p = f"decoder.decoder.layer.{i}"
            x = self.attention(x, x, sb, p + ".attention", drop)
            x = self.attention(x, enc, cb, p + ".crossattention", drop)
            x = self.ffn(x, p, drop)
        return x

    def project(self, hidden):
        return self.linear(hidden, "output_layer.layer")


class CoreView(Seq2SeqRef):
    """The translation model inside the captioner (its weights under
    ``core.``): the same mathematics, the names prefixed."""

    def __init__(self, W, cfg, prec=FP32):
        super().__init__({k[len("core."):]: v for k, v in W.items()
                          if k.startswith("core.")}, cfg, prec)


def smoothed_loss_rows(logits, targets, eps: float):
    """Label-smoothed cross-entropy per position:
    logZ - (1 - eps) x_t - (eps / V) sum_v x_v."""
    V = logits.shape[-1]
    log_z = torch.logsumexp(logits, dim=-1)
    x_t = torch.gather(logits, -1, targets[..., None])[..., 0]
    return log_z - (1.0 - eps) * x_t - (eps / V) * logits.sum(dim=-1)
