"""Image captioning model (port of
imagetranslate_tpu/models/captioning.py::ImageSeq2Seq: every parameter of the
flax tree; ``encode``/``encode_text``, ``encode_images`` (also in training
mode), ``encode_objects``; the training forwards ``caption_forward``,
``caption_forward_with_objects`` and ``multimodal_mass_forward``, the
``contrastive_loss`` and the MT passthrough ``forward``;
``init_cache``/``decode_step``, ``init_dual_cache``/``decode_step_dual`` and
``init_obj_dual_cache``/``decode_step_obj_dual``).

One module holds the text ``core`` (Seq2Seq), the ResNet grid encoder, the two
pooling heads of the contrastive objective, the learned sigmoid gates and,
under ``cfg.use_obj``, the object stream: one more decoder per decoder head
with its own input embeddings, a label embedding over the 91 COCO classes and
a bias-free projection of the detections' features. The decode surface is
``Seq2Seq``'s, so ``decoding.beam.beam_search`` takes either model; the
encoder states may be text states or the image grid.

The decoder head is a host int (``lang_idx``), so the per-language decoders
of ``lang_dec`` are plain indexing, as in ``models/seq2seq.py``. The caches
are updated in place: a decode step returns its logits (or the project_topk
triple) only. Dropout in the training forwards sits where
``models/transformer.py`` puts it, plus the ResNet grid's two sites, all
drawn from one ``dropout_stream``. ``decode_step_beams`` and the windowed
caches are TPU scheduling devices and are not ported.

Under a mesh (``shard_``) the text core and the object stream hold this
rank's shard of the JAX TP rules; the ResNet, ``object_feat_fc``, the
location embedding, the pools and the gates stay whole on every rank. With a
data group the ResNet's BatchNorm normalises with the global batch's
statistics (``models/resnet.py``), and ``contrastive_loss`` gathers the
text vectors over it.

Spans (``utils/profiling.py``): ``model.encode_images``, and
``model.decode_step`` for the dual steps (the text step's and ``encode``'s
are ``Seq2Seq``'s).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagetranslate_tpu_torch.data.images import normalize_uint8
from imagetranslate_tpu_torch.models.config import Seq2SeqConfig
from imagetranslate_tpu_torch.models.resnet import BatchNorm2d, ResNetGrid
from imagetranslate_tpu_torch.models.sensim import gather_rows, infonce_mean
from imagetranslate_tpu_torch.models.seq2seq import (
    AttentionPool,
    Seq2Seq,
    expand_langs,
    first_lang,
)
from imagetranslate_tpu_torch.models.transformer import (
    Cache,
    Decoder,
    Embedding,
    Embeddings,
    _param_dtype,
    causal_pad_bias,
    dropout_stream,
    pad_bias,
)
from imagetranslate_tpu_torch.parallel.comm import group_rank
from imagetranslate_tpu_torch.parallel.mesh import (
    Plan,
    ProcessMesh,
    module_plan,
    shard_module_,
)
from imagetranslate_tpu_torch.utils.profiling import spanned

NUM_OBJECT_LABELS = 91      # COCO classes of the detector, 0 = padding
OBJECT_FEAT_DIM = 1031      # 1024 pooled box features + 7 geometry features

DualCache = Dict[str, Cache]


def _gate(cfg: Seq2SeqConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.full((1, cfg.hidden_size), 0.1,
                                   dtype=torch.float32, device=device))


class ImageSeq2Seq(nn.Module):
    """``param_dtype`` as in ``Seq2Seq``: None stores the compute dtype (for
    serving), ``torch.float32`` holds fp32 masters. ``object_feat_dim`` is
    the width of a detection's features (flax infers it from the first
    input)."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, param_dtype=None,
                 object_feat_dim: int = OBJECT_FEAT_DIM):
        super().__init__()
        self.cfg = cfg
        self.core = Seq2Seq(cfg, device, param_dtype)
        self.image_model = ResNetGrid(
            cfg.hidden_size, depth=cfg.resnet_depth, dropout=cfg.dropout,
            img_size=cfg.img_size, dtype=cfg.compute_dtype, device=device,
            param_dtype=param_dtype)
        self.multimodal_attention_gate = _gate(cfg, device)
        self.image_attention = AttentionPool(cfg, device, param_dtype)
        self.encoder_attention = AttentionPool(cfg, device, param_dtype)
        if cfg.use_obj:
            if cfg.lang_dec:
                n = cfg.num_languages
                self.obj_decoder = nn.ModuleList(
                    [Decoder(cfg, device, param_dtype) for _ in range(n)])
                self.obj_embeddings = nn.ModuleList(
                    [Embeddings(cfg, device, param_dtype) for _ in range(n)])
            else:
                self.obj_decoder = Decoder(cfg, device, param_dtype)
                self.obj_embeddings = Embeddings(cfg, device, param_dtype)
            self.multistream_attention_gate = _gate(cfg, device)
            self.object_embedding = Embedding(
                NUM_OBJECT_LABELS, cfg.hidden_size, cfg.compute_dtype,
                device=device, dtype=_param_dtype(cfg, param_dtype))
            self.object_feat_fc = nn.Linear(
                object_feat_dim, cfg.hidden_size, bias=False, device=device,
                dtype=_param_dtype(cfg, param_dtype))

    @property
    def mesh(self) -> Optional[ProcessMesh]:
        return self.core.mesh

    @property
    def vocab_tp(self) -> Optional[ProcessMesh]:
        return self.core.vocab_tp

    def vocab_range(self):
        return self.core.vocab_range()

    def shard_(self, mesh: ProcessMesh) -> Plan:
        """Keep this rank's shard of every parameter (the JAX TP rules over
        the whole tree: the text core and the object stream split, the rest
        whole), in place, and return the plan; BatchNorm takes the data
        group's statistics."""
        plan = module_plan(self, mesh, self.cfg)
        shard_module_(self, mesh, plan)
        self.core.bind_mesh(mesh, plan, "core.")
        for mod in self.image_model.modules():
            if isinstance(mod, BatchNorm2d):
                mod.dp = mesh.data_group
        return plan

    def _drop(self, deterministic: bool, rng, device):
        return dropout_stream(deterministic, rng, device, self.core.mesh)

    def _obj_decoder(self, lang_idx: int) -> Decoder:
        return (self.obj_decoder[lang_idx] if self.cfg.lang_dec
                else self.obj_decoder)

    def _obj_embed(self, lang_idx: int) -> Embeddings:
        return (self.obj_embeddings[lang_idx] if self.cfg.lang_dec
                else self.obj_embeddings)

    # ---------------- encoders ----------------

    def encode(self, src_ids, src_mask, src_langs,
               deterministic: bool = True, rng=None):
        """Same name as ``Seq2Seq.encode``, so the decode loops take either
        model."""
        return self.core.encode(src_ids, src_mask, src_langs, deterministic,
                                rng=rng)

    encode_text = encode

    @spanned("model.encode_images")
    def encode_images(self, images, train: bool = False,
                      deterministic: bool = True, rng=None):
        """images [B, S, S, 3] -> grid [B, (S/32)^2, E]. uint8 input is
        normalised on the device (``/255``, ImageNet mean and std: the
        arithmetic ``data.images.load_image`` does on the host for float
        input), so the host ships one byte a pixel. With
        ``cfg.freeze_image`` the grid carries no gradient."""
        if images.dtype == torch.uint8:
            images = normalize_uint8(images)
        drop = self._drop(deterministic, rng, images.device)
        grid = self.image_model(images, train=train, drop=drop)
        return grid.detach() if self.cfg.freeze_image else grid

    def encode_objects(self, box_features, object_labels):
        """Precomputed detections -> (object-stream states [B, O, E], keep
        [B, O]): [box features | 7 geometry] through a bias-free Linear,
        plus the label's embedding, ReLU; rows of label 0 are padding and
        come out zero."""
        x = box_features.to(self.cfg.compute_dtype)
        feats = F.linear(x, self.object_feat_fc.weight.to(x.dtype))
        out = torch.relu(feats + self.object_embedding(object_labels))
        keep = object_labels != 0
        return torch.where(keep[..., None], out, 0.0), keep

    # ---------------- training forwards ----------------

    def _text_in(self, captions, caption_mask, langs, tgt_positions, drop):
        """(decoder head, embedded captions[:, :-1], causal self bias)."""
        B, T = captions.shape
        lang_idx = first_lang(langs) if self.cfg.lang_dec else 0
        if tgt_positions is None:
            pos = torch.arange(T - 1, device=captions.device)[None, :].expand(
                B, T - 1)
        else:
            pos = tgt_positions[:, :-1]
        lang_ids = expand_langs(langs, T)[:, :-1]
        x = self.core.embeddings(captions[:, :-1], pos, lang_ids, drop)
        return lang_idx, pos, lang_ids, x, causal_pad_bias(
            caption_mask[:, :-1])

    def caption_forward(self, images, captions, caption_mask, langs,
                        tgt_positions=None, train: bool = False,
                        deterministic: bool = True, rng=None):
        """Captions decoded against the image grid: fp32 logits
        [B, T-1, V] for captions[:, 1:]. ``train`` normalises the ResNet
        with the batch's statistics and moves its running ones;
        ``deterministic=False`` turns dropout on, its seeds drawn from
        ``rng`` (a host torch.Generator)."""
        drop = self._drop(deterministic, rng, captions.device)
        grid = self.encode_images(images, train, deterministic, rng=drop)
        logits, _ = self._decode_over(grid, None, captions, caption_mask,
                                      langs, tgt_positions, drop)
        return logits

    def _decode_over(self, enc_states, enc_mask, captions, caption_mask,
                     langs, tgt_positions, drop):
        """The text decoder over ``enc_states`` (every slot kept when
        ``enc_mask`` is None): (logits, hidden)."""
        lang_idx, _, _, x, self_bias = self._text_in(
            captions, caption_mask, langs, tgt_positions, drop)
        if enc_mask is None:
            enc_mask = torch.ones(enc_states.shape[:2], dtype=torch.bool,
                                  device=enc_states.device)
        hidden = self.core._decoder(lang_idx)(
            x, enc_states, self_bias, pad_bias(enc_mask), drop)
        return self.core.project(hidden, lang_idx), hidden

    def caption_forward_with_objects(self, images, box_features,
                                     object_labels, captions, caption_mask,
                                     langs, train: bool = False,
                                     deterministic: bool = True, rng=None):
        """Dual-stream captioning: the grid decoder and the object decoder
        (over the detections, padding masked), blended by
        sigmoid(multistream gate + 1e-7), projected once."""
        drop = self._drop(deterministic, rng, captions.device)
        grid = self.encode_images(images, train, deterministic, rng=drop)
        obj_states, obj_keep = self.encode_objects(box_features,
                                                   object_labels)
        lang_idx, pos, lang_ids, x, self_bias = self._text_in(
            captions, caption_mask, langs, None, drop)
        grid_mask = torch.ones(grid.shape[:2], dtype=torch.bool,
                               device=grid.device)
        main_out = self.core._decoder(lang_idx)(
            x, grid, self_bias, pad_bias(grid_mask), drop)
        x_obj = self._obj_embed(lang_idx)(captions[:, :-1], pos, lang_ids,
                                          drop)
        obj_out = self._obj_decoder(lang_idx)(
            x_obj, obj_states, self_bias, pad_bias(obj_keep), drop)
        gate = torch.sigmoid(self.multistream_attention_gate + 1e-7).to(
            main_out.dtype)
        return self.core.project(gate * main_out + (1.0 - gate) * obj_out,
                                 lang_idx)

    def multimodal_mass_forward(self, images, src_ids, src_mask, src_langs,
                                dec_inputs, dec_mask, tgt_positions,
                                train: bool = False,
                                deterministic: bool = True, rng=None):
        """MASS over captions with the image stream blended in: the span
        (``dec_inputs``, at ``tgt_positions``) is decoded against the
        corrupted caption's encoding and against the image grid, and the two
        decoder outputs are blended by sigmoid(multimodal gate + 1e-7)
        before the one vocab projection. fp32 logits [B, W-1, V]."""
        drop = self._drop(deterministic, rng, src_ids.device)
        enc_states = self.core.encode(src_ids, src_mask, src_langs,
                                      deterministic, rng=drop)
        grid = self.encode_images(images, train, deterministic, rng=drop)
        lang_idx, _, _, x, self_bias = self._text_in(
            dec_inputs, dec_mask, src_langs, tgt_positions, drop)
        dec = self.core._decoder(lang_idx)
        text_out = dec(x, enc_states, self_bias, pad_bias(src_mask), drop)
        grid_mask = torch.ones(grid.shape[:2], dtype=torch.bool,
                               device=grid.device)
        img_out = dec(x, grid, self_bias, pad_bias(grid_mask), drop)
        gate = torch.sigmoid(self.multimodal_attention_gate + 1e-7).to(
            text_out.dtype)
        return self.core.project(gate * text_out + (1.0 - gate) * img_out,
                                 lang_idx)

    def contrastive_loss(self, images, captions, caption_mask, langs,
                         neg_samples, neg_mask, neg_langs,
                         train: bool = False, deterministic: bool = True,
                         row_mask=None, rng=None, data_group=None,
                         neg_group=None, count=None):
        """InfoNCE between the attention-pooled image grid and the pooled
        caption encodings, the text negatives as extra columns: a scalar,
        the mean over the rows ``row_mask`` keeps (all rows when None).
        Padding rows leave the anchors and the in-batch negative columns;
        their columns take -1e9, not -inf, whose 0-weighted product would
        be NaN. ``data_group`` / ``neg_group``: the group over which the
        captions' / the negatives' rows are split (the text vectors are
        gathered over it: ``cross = img_vec @ text_vecs.T`` over the global
        [B, B + N]); ``count``: the divisor of the mean."""
        drop = self._drop(deterministic, rng, captions.device)
        enc = self.core.encode(captions, caption_mask, langs, deterministic,
                               rng=drop)
        pos_vec = self.encoder_attention(enc, caption_mask)
        neg_enc = self.core.encode(neg_samples, neg_mask, neg_langs,
                                   deterministic, rng=drop)
        neg_vec = self.encoder_attention(neg_enc, neg_mask)
        pos_all = gather_rows(pos_vec, data_group)
        neg_all = gather_rows(neg_vec, neg_group)
        text_vecs = torch.cat([pos_all, neg_all], dim=0)
        grid = self.encode_images(images, train, deterministic, rng=drop)
        img_vec = self.image_attention(grid, None)

        def l2norm(v):
            v = v.to(torch.float32)
            return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                        + 1e-4)

        cross = l2norm(img_vec) @ l2norm(text_vecs).T        # [B, Bg + N]
        B = pos_vec.shape[0]
        if row_mask is not None:
            col_keep = torch.cat([gather_rows(row_mask, data_group),
                                  torch.ones(neg_all.shape[0],
                                             dtype=torch.bool,
                                             device=row_mask.device)])
            cross = torch.where(col_keep[None, :], cross, -1e9)
        denom = torch.log(torch.sum(torch.exp(cross), dim=-1) + 1e-4)
        first = 0 if data_group is None else group_rank(data_group) * B
        rows = torch.arange(B, device=cross.device)
        nom = cross[rows, first + rows] + 1e-4
        keep = (torch.ones(B, dtype=torch.bool, device=cross.device)
                if row_mask is None else row_mask)
        return infonce_mean(denom - nom, keep, count)

    def forward(self, *args, **kw):
        """The text model's forward (the MT stream of multi-task
        training)."""
        return self.core(*args, **kw)

    # ---------------- decoding ----------------

    def init_cache(self, enc_states, batch: int, max_len: int,
                   lang_idx: int = 0) -> Cache:
        return self.core.init_cache(enc_states, batch, max_len, lang_idx)

    def decode_step(self, prev_token, cache: Cache, index: int, cross_bias,
                    tgt_langs, lang_idx: Optional[int] = None,
                    proposals=None, proposal_mask=None,
                    topk: Optional[int] = None):
        return self.core.decode_step(prev_token, cache, index, cross_bias,
                                     tgt_langs, lang_idx=lang_idx,
                                     proposals=proposals,
                                     proposal_mask=proposal_mask, topk=topk)

    def _embed_step(self, emb: Embeddings, prev_token, index: int, tgt_langs):
        B = prev_token.shape[0]
        positions = torch.full((B, 1), index, dtype=torch.long,
                               device=prev_token.device)
        return emb(prev_token, positions, expand_langs(tgt_langs, 1))

    def _blend(self, gate_param, h_a, h_b, lang_idx: int,
               topk: Optional[int]):
        """sigmoid(gate) * h_a + (1 - sigmoid(gate)) * h_b, then the vocab
        projection (or its top-k)."""
        gate = torch.sigmoid(gate_param + 1e-7)
        blended = gate.to(h_a.dtype) * h_a + (1.0 - gate).to(h_b.dtype) * h_b
        if topk is not None:
            return self.core.project_topk(blended, topk, lang_idx)
        return self.core.project(blended, lang_idx)[:, 0, :]

    # Gated dual-stream decoding: the decoder runs against the text encoding
    # AND the image grid with separate KV caches (the streams share the token
    # embeddings and part from the first cross-attention on); the two hidden
    # states are blended by sigmoid(multimodal gate) and projected once.

    def init_dual_cache(self, enc_text, grid, batch: int, max_len: int,
                        lang_idx: int = 0) -> DualCache:
        return {
            "text": self.core.init_cache(enc_text, batch, max_len, lang_idx),
            "img": self.core.init_cache(grid, batch, max_len, lang_idx),
        }

    @spanned("model.decode_step")
    def decode_step_dual(self, prev_token, cache: DualCache, index: int,
                         cross_bias_text, cross_bias_img, tgt_langs,
                         lang_idx: Optional[int] = None,
                         topk: Optional[int] = None):
        if lang_idx is None:
            lang_idx = first_lang(tgt_langs)
        x = self._embed_step(self.core.embeddings, prev_token, index,
                             tgt_langs)
        dec = self.core._decoder(lang_idx)
        h_text = dec.step(x, cache["text"], index, cross_bias_text)
        h_img = dec.step(x, cache["img"], index, cross_bias_img)
        return self._blend(self.multimodal_attention_gate, h_text, h_img,
                           lang_idx, topk)

    # Object-stream decoding: the grid decoder and the object decoder, each
    # with its own KV cache (and the object decoder with its own input
    # embeddings), blended by sigmoid(multistream gate) every step.

    def init_obj_dual_cache(self, grid, obj_states, batch: int, max_len: int,
                            lang_idx: int = 0) -> DualCache:
        return {
            "img": self.core.init_cache(grid, batch, max_len, lang_idx),
            "obj": self._obj_decoder(lang_idx).init_cache(obj_states, batch,
                                                          max_len),
        }

    @spanned("model.decode_step")
    def decode_step_obj_dual(self, prev_token, cache: DualCache, index: int,
                             cross_bias_img, cross_bias_obj, tgt_langs,
                             lang_idx: Optional[int] = None,
                             topk: Optional[int] = None):
        if lang_idx is None:
            lang_idx = first_lang(tgt_langs)
        x = self._embed_step(self.core.embeddings, prev_token, index,
                             tgt_langs)
        x_obj = self._embed_step(self._obj_embed(lang_idx), prev_token,
                                 index, tgt_langs)
        h_img = self.core._decoder(lang_idx).step(x, cache["img"], index,
                                                  cross_bias_img)
        h_obj = self._obj_decoder(lang_idx).step(x_obj, cache["obj"], index,
                                                 cross_bias_obj)
        return self._blend(self.multistream_attention_gate, h_img, h_obj,
                           lang_idx, topk)
