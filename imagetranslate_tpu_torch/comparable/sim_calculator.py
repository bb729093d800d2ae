"""Embedding max-cosine sentence similarity with dictionary boosts and digit
masks (port of imagetranslate_tpu/comparable/sim_calculator.py), scored on
the card.

Flags match the JAX tool: --src/--dst parallel candidate files,
--src-embed/--dst-embed word-vector text files, --dict TSV dictionary,
--output per-line similarity scores, --convert normalizes non-ASCII digits;
--device (default cuda) says where the scoring runs.

The word-vector files are parsed and normalized on the host as the JAX tool
does (``read_embed``); the two tables then live on the device. Candidate
pairs go in batches of padded word rows [P, Ls] and [P, Ld]: a gather of
both sides' vectors, an fp32 bmm, the max over each src word's real dst
words, then the boost and number flags as [P, Ls] tensors and the sum over
the real src words. The flags come from integer word ids: every distinct
word is interned once on the host with its table rows and its digit-normal
string's id, so that identity, dictionary and number matches are integer
comparisons on the device. Each pair's score depends on its own words only:
padding is masked out of the max and the sum.

    python -m imagetranslate_tpu_torch.comparable.sim_calculator \
        --src S --dst D --src-embed SE --dst-embed DE [--dict TSV] \
        --output OUT [--convert] [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import time
from collections import defaultdict

import numpy as np
import torch

DIGIT_REPL = {"۰": "0", "۱": "1", "۲": "2", "۳": "3", "۴": "4", "۵": "5",
              "۶": "6", "۷": "7", "۸": "8", "۹": "9", "٫": ".", "૦": "0",
              "०": "0", "૧": "1", "१": "1", "૨": "2", "२": "2", "૩": "3",
              "३": "3", "૪": "4", "४": "4", "૫": "5", "५": "5", "૬": "6",
              "६": "6", "૭": "7", "७": "7", "૮": "8", "८": "8", "૯": "9",
              "९": "9"}

# A batch holds at most WORD_BUDGET padded words (both sides) and
# CELL_BUDGET padded (src word, dst word) cells; CHUNK pairs are read from
# the files at a time and sorted by length into batches.
WORD_BUDGET = 1 << 17
CELL_BUDGET = 1 << 21
CHUNK = 1 << 16
POISON = -100.0  # an unmatched number poisons its src word's term


_DIGIT_TABLE = str.maketrans(DIGIT_REPL)


def digit_replace(tok, convert):
    if not convert:
        return tok
    return tok.translate(_DIGIT_TABLE)


def embed_table(vectors: np.ndarray) -> np.ndarray:
    """Raw word vectors [V, D] -> the [V+1, D] float32 table: row 0 the raw
    1e-4 vector (OOV words and all-OOV dst sides read it, never
    normalized), real rows divided by their norm + 1e-4."""
    vectors = np.asarray(vectors, np.float32)
    arr = np.concatenate(
        [np.full((1, vectors.shape[1]), 1e-4, np.float32), vectors])
    arr[1:] /= np.linalg.norm(arr[1:], axis=-1, keepdims=True) + 1e-4
    return arr


def read_embed(path):
    """Word-vector text file -> (normalized [V+1, D] array, {word: row}).
    Lines of fewer than 3 fields, and lines whose width differs from the
    first vector's, are skipped."""
    vectors, index = [], {}
    dim = None
    with open(path) as r:
        for line in r:
            spl = line.strip().split(" ")
            if len(spl) < 3:
                continue
            v = np.array([float(x) for x in spl[1:]], np.float32)
            if dim is None:
                dim = len(v)
            if len(v) != dim:
                continue
            vectors.append(v)
            index[spl[0]] = len(index) + 1
    return embed_table(np.stack(vectors)), index


def read_dict(path):
    d = defaultdict(set)
    if path is None:
        return d
    with open(path) as r:
        for line in r:
            spl = line.strip().split("\t")
            if len(spl) == 2:
                d[spl[0].lower()].add(spl[1].lower())
    return d


@contextlib.contextmanager
def _ieee_fp32():
    """fp32 products without TF32, whatever the caller's setting."""
    m = torch.backends.cuda.matmul
    old = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = old


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to score on the host)")
    return device


class SimScorer:
    """Scores (src words, dst words) pairs as the JAX tool's
    ``sentence_sim`` does, in batches on ``device``.

    ``host_seconds`` and ``device_seconds`` add up the time spent building
    the batches' index tensors on the host and the time from their upload
    to the scores back on the host."""

    def __init__(self, src_table, src_idx, dst_table, dst_idx, d=None,
                 convert=False, device="cuda"):
        self.device = resolve_device(device)
        self.src_table = torch.as_tensor(src_table).to(self.device)
        self.dst_table = torch.as_tensor(dst_table).to(self.device)
        self.src_idx, self.dst_idx = src_idx, dst_idx
        self.convert = convert
        self.host_seconds = 0.0
        self.device_seconds = 0.0
        self._ids: dict = {}
        self._nums: dict = {}
        # per interned word: src row, dst row (-1: OOV), digit-normal id
        # (-1: not a number)
        self._attr = np.empty((1024, 3), np.int64)
        keys = [self._intern(w) << 32 | self._intern(t)
                for w, ts in (d or {}).items() for t in ts]
        self._dict_keys = torch.as_tensor(
            np.unique(np.asarray(keys, np.int64)), device=self.device)

    def _intern(self, w: str) -> int:
        i = self._ids.get(w)
        if i is not None:
            return i
        i = len(self._ids)
        if i == len(self._attr):
            self._attr = np.concatenate([self._attr, np.empty_like(self._attr)])
        ds = digit_replace(w, self.convert)
        num = (self._nums.setdefault(ds, len(self._nums))
               if ds.replace(".", "", 1).isdigit() else -1)
        dst = self.dst_idx.get(w, self.dst_idx.get(w.lower()))
        self._attr[i] = (self.src_idx.get(w, self.src_idx.get(w.lower(), 0)),
                         -1 if dst is None else dst, num)
        self._ids[w] = i
        return i

    def _ids_of(self, sens, pad: int):
        """Word lists -> ([P, L] ids padded with ``pad``, [P, L] real)."""
        ids, intern = self._ids, self._intern
        flat = [ids[w] if w in ids else intern(w) for s in sens for w in s]
        lens = np.fromiter((len(s) for s in sens), np.int64, len(sens))
        real = np.arange(max(lens.max(), 1)) < lens[:, None]
        out = np.full(real.shape, pad, np.int64)
        out[real] = flat
        return out, real

    def _attrs(self, ids, real):
        """[P, L, 3] attributes of ``ids``; padding reads (0, -1, -1)."""
        a = self._attr[np.where(real, ids, 0)]
        a[~real] = (0, -1, -1)
        return a

    def score(self, src_sens, dst_sens) -> np.ndarray:
        """Lists of word lists -> [P] float32 scores, in the pairs' order."""
        n = len(src_sens)
        out = np.empty(n, np.float32)
        if n == 0:
            return out
        ls = [len(s) for s in src_sens]
        ld = [len(s) for s in dst_sens]
        order = np.lexsort((ld, ls)).tolist()
        start = 0
        while start < n:
            end, ms, md = start, 0, 0
            while end < n:
                i = order[end]
                ms2, md2 = max(ms, ls[i]), max(md, ld[i])
                p = end - start + 1
                if end > start and (p * (ms2 + md2) > WORD_BUDGET
                                    or p * ms2 * md2 > CELL_BUDGET):
                    break
                ms, md, end = ms2, md2, end + 1
            rows = order[start:end]
            out[rows] = self._score_batch([src_sens[i] for i in rows],
                                          [dst_sens[i] for i in rows])
            start = end
        return out

    @torch.no_grad()
    def _score_batch(self, src_sens, dst_sens) -> np.ndarray:
        t0 = time.perf_counter()
        s_ids, s_real = self._ids_of(src_sens, -1)
        d_ids, d_real = self._ids_of(dst_sens, -2)
        s_attr, d_attr = self._attrs(s_ids, s_real), self._attrs(d_ids, d_real)
        t1 = time.perf_counter()
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        s_ids, s_real, d_ids, d_real = (up(s_ids), up(s_real), up(d_ids),
                                        up(d_real))
        s_row, s_num = up(s_attr[..., 0]), up(s_attr[..., 2])
        d_row, d_num = up(d_attr[..., 1]), up(d_attr[..., 2])
        # The cosine runs over the dst words that have a vector; a pair with
        # none scores against row 0 alone.
        d_vec = d_real & (d_row >= 0)
        d_row = torch.where(d_vec, d_row, 0)
        d_vec[:, 0] |= ~d_vec.any(1)
        sv = self.src_table[s_row]
        dv = self.dst_table[d_row]
        with _ieee_fp32():
            cos = torch.bmm(sv, dv.transpose(1, 2))
        cos.masked_fill_(~d_vec[:, None, :], float("-inf"))
        max_cos = cos.amax(2)

        hit = s_ids[:, :, None] == d_ids[:, None, :]
        if len(self._dict_keys):
            keys = s_ids[:, :, None] * (1 << 32) + d_ids[:, None, :]
            pos = torch.searchsorted(self._dict_keys, keys)
            pos.clamp_(max=len(self._dict_keys) - 1)
            hit |= self._dict_keys[pos] == keys
        hit &= d_real[:, None, :]
        num_hit = ((s_num[:, :, None] == d_num[:, None, :])
                   & (s_num >= 0)[:, :, None] & d_real[:, None, :])
        boost = hit.any(2)
        digit_ok = (s_num < 0) | boost | num_hit.any(2)
        val = torch.maximum(max_cos, boost.to(max_cos.dtype))
        val = torch.where(digit_ok, val, POISON)
        val = torch.where(s_real, val, 0.0)
        scores = val.double().sum(1).float().cpu().numpy()
        t2 = time.perf_counter()
        self.host_seconds += t1 - t0
        self.device_seconds += t2 - t1
        return scores


def main(argv=None):
    p = argparse.ArgumentParser("sim_calculator")
    p.add_argument("--src", dest="src_file", required=True)
    p.add_argument("--dst", dest="dst_file", required=True)
    p.add_argument("--src-embed", required=True)
    p.add_argument("--dst-embed", required=True)
    p.add_argument("--dict", dest="src2dst_dict", default=None)
    p.add_argument("--output", dest="output_file", required=True)
    p.add_argument("--convert", dest="convert_numbers", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (cuda, cuda:N or cpu)")
    a = p.parse_args(argv)

    device = resolve_device(a.device)
    src_embed, src_idx = read_embed(a.src_embed)
    dst_embed, dst_idx = read_embed(a.dst_embed)
    scorer = SimScorer(src_embed, src_idx, dst_embed, dst_idx,
                       read_dict(a.src2dst_dict), a.convert_numbers, device)
    with open(a.src_file) as sr, open(a.dst_file) as dr, \
            open(a.output_file, "w") as w:
        pairs = zip(sr, dr)
        while chunk := list(itertools.islice(pairs, CHUNK)):
            scores = scorer.score(
                [s.lower().strip().split(" ") for s, _ in chunk],
                [t.lower().strip().split(" ") for _, t in chunk])
            w.write("".join(str(float(x)) + "\n" for x in scores))
    print("Done!")


if __name__ == "__main__":
    main()
