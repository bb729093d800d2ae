"""The port's host side of the LM path against the JAX package's: the
document tokenizer (``tokenize_one_line``, ``tokenize_lines`` blind and at
sentence boundaries, ``split_tokenized``), ``write_doc_blocks`` byte for byte
(the final empty block at exact multiples included) and
``DocBlockDataset.batches`` array for array, on documents made from a numpy
seed. Both packages read one tokenizer directory.
"""

import marshal
import os

import numpy as np
import pytest

from imagetranslate_tpu.data import binarize as jbinarize
from imagetranslate_tpu.data.loader import DocBlockDataset as JaxDocBlockDataset
from imagetranslate_tpu.text.processor import TextProcessor as JaxTextProcessor
from imagetranslate_tpu_torch.data import binarize
from imagetranslate_tpu_torch.data.loader import DocBlockDataset
from imagetranslate_tpu_torch.text.processor import TextProcessor

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "café",
         "naïve"]
LANGS = {"<en>": 0, "<fa>": 1}


def _sentence(rng, lo=2, hi=9):
    return " ".join(WORDS[j] for j in rng.randint(0, len(WORDS),
                                                  rng.randint(lo, hi)))


def _doc(rng, lang, n_sent):
    return f"<{lang}> " + " </s> ".join(_sentence(rng)
                                        for _ in range(n_sent)) + " </s>"


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    d = tmp_path_factory.mktemp("lmtok")
    rng = np.random.RandomState(0)
    corpus = d / "corpus.txt"
    corpus.write_text("\n".join(_sentence(rng) for _ in range(300)),
                      encoding="utf-8")
    TextProcessor().train_tokenizer([str(corpus)], 120, str(d / "tok"), LANGS)
    nolang = d / "tok_nolang"
    TextProcessor().train_tokenizer([str(corpus)], 120, str(nolang), {})
    return d


def _pair(tok, name="tok"):
    return JaxTextProcessor(str(tok / name)), TextProcessor(str(tok / name))


def test_tokenize_one_line_equals_jax(tok):
    jtp, tp = _pair(tok)
    rng = np.random.RandomState(1)
    lines = [_doc(rng, "en", 3), _doc(rng, "fa", 1),
             " </s> ".join(_sentence(rng) for _ in range(2)),   # no <lang>
             "<en> " + _sentence(rng), "", " </s>  </s> "]
    for line in lines:
        for ignore in (False, True):
            assert tp.tokenize_one_line(line, ignore) == \
                jtp.tokenize_one_line(line, ignore), (line, ignore)
    assert tp.is_lang(tp.token_id("<fa>")) and not tp.is_lang(4)


@pytest.mark.parametrize("name", ["tok", "tok_nolang"])
def test_tokenize_lines_equals_jax(tok, name):
    jtp, tp = _pair(tok, name)
    rng = np.random.RandomState(2)
    docs = [_doc(rng, "en", n) for n in (1, 2, 7, 30)] + [_doc(rng, "fa", 12)]
    for doc in docs:
        for split_len in (8, 16, 64):
            want = jtp.tokenize_lines(doc, blind_split=True,
                                      split_len=split_len)
            got = tp.tokenize_lines(doc, blind_split=True,
                                    split_len=split_len)
            assert got.shape == want.shape and got.shape[1] == split_len
            np.testing.assert_array_equal(got, want)
        if name == "tok":
            assert tp.tokenize_lines(doc) == jtp.tokenize_lines(doc)
        else:
            # Without languages no sentence is measured and the chunk width
            # is 0: the JAX package never returns; the port refuses.
            with pytest.raises(ValueError, match="max_length"):
                tp.tokenize_lines(doc)


def test_blind_split_at_exact_multiples(tok):
    """A document of exactly n * split_len tokens gets n rows and no all-pad
    row (the ``-n % split_len`` rule), in both packages."""
    jtp, tp = _pair(tok)
    rng = np.random.RandomState(3)
    doc = _doc(rng, "en", 6)
    n = len(tp.tokenize_lines(doc, blind_split=True, split_len=1))
    for split_len in (n, n // 2 if n % 2 == 0 else n, 1):
        got = tp.tokenize_lines(doc, blind_split=True, split_len=split_len)
        assert got.shape == (n // split_len, split_len)
        assert (got != tp.pad_token_id()).all()
        np.testing.assert_array_equal(
            got, jtp.tokenize_lines(doc, blind_split=True,
                                    split_len=split_len))
    got = tp.tokenize_lines(doc, blind_split=True, split_len=n + 3)
    assert got.shape == (1, n + 3) and (got[0, n:] == 0).all()


def test_split_tokenized_equals_jax(tok):
    jtp, tp = _pair(tok)
    rng = np.random.RandomState(4)
    for lang, n_sent in (("en", 9), ("fa", 20), ("en", 1)):
        ids = tp.tokenize_one_line(_doc(rng, lang, n_sent))
        for max_length in (12, 20, 33, 512):
            got = tp.split_tokenized(ids, max_length)
            assert got == jtp.split_tokenized(ids, max_length)
            assert len(got[-1]) == max_length or len(ids) > max_length
    # No language token in front: chunks are not prefixed.
    bare = tp.tokenize_one_line(_doc(rng, "en", 8))[1:]
    assert tp.split_tokenized(bare, 14) == jtp.split_tokenized(bare, 14)


def _write_docs(path, n_docs, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n_docs):
            f.write(_doc(rng, "en" if i % 3 else "fa",
                         rng.randint(1, 12)) + "\n")
            if i % 5 == 0:
                f.write("\n")                          # blank lines are skipped


@pytest.mark.parametrize("seq_len,block", [(16, 7), (32, 1000), (8, 1)])
def test_write_doc_blocks_byte_for_byte(tok, tmp_path, seq_len, block):
    jtp, tp = _pair(tok)
    docs = tmp_path / "docs.txt"
    _write_docs(docs, 25, seed=5)
    jn = jbinarize.write_doc_blocks(jtp, str(docs), str(tmp_path / "jax"),
                                    seq_len=seq_len, sen_block_size=block)
    n = binarize.write_doc_blocks(tp, str(docs), str(tmp_path / "port"),
                                  seq_len=seq_len, sen_block_size=block)
    assert n == jn > 25
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "info.txt" in names and "0.pkl" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    if block == 1:
        # Rows are an exact multiple of the block size: a final EMPTY block.
        with open(tmp_path / "port" / f"{n}.pkl", "rb") as f:
            assert marshal.load(f) == {}
    with pytest.raises(NotImplementedError, match="module 15"):
        binarize.write_doc_blocks(tp, str(docs), str(tmp_path / "p2"),
                                  packed=True)


def test_doc_block_dataset_equals_jax(tok, tmp_path):
    _, tp = _pair(tok)
    docs = tmp_path / "docs.txt"
    _write_docs(docs, 30, seed=6)
    cache = tmp_path / "blocks"
    n = binarize.write_doc_blocks(tp, str(docs), str(cache), seq_len=16,
                                  sen_block_size=9)
    for kw in (dict(max_cache_size=2), dict(load_all=True)):
        jds = JaxDocBlockDataset(str(cache), **kw)
        ds = DocBlockDataset(str(cache), **kw)
        assert len(ds) == len(jds) == n
        assert (ds.sentence_block_size, ds.file_count) == \
            (jds.sentence_block_size, jds.file_count)
        for i in (0, n - 1, 9, 8, 20, 3):              # across the block cache
            assert ds[i] == jds[i] and ds.lang_at(i) == jds.lang_at(i)
        for rows in (4, 7, n + 3):
            got = list(ds.batches(rows, pad_id=0))
            want = list(jds.batches(rows, pad_id=0))
            assert len(got) == len(want) == -(-n // rows)
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for key in w:
                    assert g[key].dtype == w[key].dtype, key
                    np.testing.assert_array_equal(g[key], w[key], key)
            tail = got[-1]
            real = n - (len(got) - 1) * rows
            assert tail["row_mask"].sum() == real
            assert (tail["texts"][real:] == tail["texts"][0]).all()
        got = next(ds.batches(4, lang_of=lambda r: r[0] % 2))
        want = next(jds.batches(4, lang_of=lambda r: r[0] % 2))
        np.testing.assert_array_equal(got["langs"], want["langs"])
    assert {ds.lang_at(i) for i in range(n)} == {0, 1}


def test_doc_block_dataset_bare_lists_and_packed_blocks(tmp_path):
    """The older layout (a marshal list of bare id rows, language 0) reads as
    in the JAX package; a packed record block is refused."""
    rows = [[5, 6, 7, 0], [8, 9, 0, 0], [10, 11, 12, 13]]
    with open(tmp_path / "0.pkl", "wb") as f:
        marshal.dump(rows, f)
    (tmp_path / "info.txt").write_text("10\t3\t1")
    ds, jds = DocBlockDataset(str(tmp_path)), JaxDocBlockDataset(str(tmp_path))
    for g, w in zip(ds.batches(2), jds.batches(2)):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], key)
    assert ds.lang_at(2) == 0 and ds[1] == rows[1]
    (tmp_path / "0.pkl").write_bytes(b"ITR1" + b"\0" * 16)
    with pytest.raises(NotImplementedError, match="module 15"):
        DocBlockDataset(str(tmp_path), load_all=True)
