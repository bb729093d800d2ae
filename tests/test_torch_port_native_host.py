"""The port's native host libraries against the JAX package's:

- ``text/native.py``: the C++ BPE encode equals the JAX package's native and
  Python encoders and the port's Python encoder, word for word, on unicode,
  unknown characters, empty text and a line longer than the output buffer;
  ``train_merges_native`` gives the JAX trainer's merges, and ``train_bpe``
  the same artifact with and without it, also on a TSV whose words hold
  tabs; ``TextProcessor`` encodes through
  it;
- ``data/imagedec.py``: the port's ``load_image`` equals the JAX package's
  default path (native decoder, ``FAST_DCT_SCALE`` on) exactly, on a JPEG of
  1024 pixels where the DCT prescale engages, on a grayscale JPEG and on a
  PNG (Pillow in both); the fallbacks of tests/test_imagedec.py (not a
  JPEG, a missing file, a truncated JPEG -> None, and a black image through
  ``load_image``); the libraries land in the port's build directory.
"""

import os

import numpy as np
import pytest

from imagetranslate_tpu.data import imagedec as jdec
from imagetranslate_tpu.data import images as jimages
from imagetranslate_tpu.text import bpe as jbpe
from imagetranslate_tpu.text import native as jnative
from imagetranslate_tpu_torch.data import imagedec as pdec
from imagetranslate_tpu_torch.data import images as pimages
from imagetranslate_tpu_torch.text import bpe as pbpe
from imagetranslate_tpu_torch.text import native as pnative
from imagetranslate_tpu_torch.text.processor import TextProcessor
from imagetranslate_tpu_torch.utils import native as build

Image = pytest.importorskip("PIL.Image")

LINES = ["the quick brown fox jumps over the lazy dog",
         "pack my box with five dozen liquor jugs",
         "ḟancy ünïcode ŧext — with em-dashes…"] * 40
TEXTS = ["the quick brown fox", "dozens of quick jumps", "ünïcode ŧext here",
         "unknown 世界 chars 世世", "", "   ", "word",
         "世界" * 40000]   # more ids than the 65536 buffer holds
SPECIALS = ["<pad>", "<s>", "<unk>", "<mask>", "</s>"]


@pytest.fixture(scope="module")
def text_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("bpe") / "text.txt"
    p.write_text("\n".join(LINES), encoding="utf-8")
    return str(p)


def test_native_bpe_encode_equals_jax(text_file):
    py = pbpe.train_bpe([text_file], 300, SPECIALS, use_native=False)
    jpy = jbpe.train_bpe([text_file], 300, SPECIALS, use_native=False)
    native, jnat = pnative.NativeBPE(py), jnative.NativeBPE(jpy)
    assert native.ok and jnat.ok
    for text in TEXTS:
        want = jnat.encode(text)
        assert native.encode(text) == want == py.encode(text) == \
            jpy.encode(text), text[:40]
    assert len(native.encode(TEXTS[-1])) > native.MAX_OUT
    assert native.decode(native.encode(TEXTS[0])) == TEXTS[0]
    assert native.get_vocab_size() == py.get_vocab_size()
    assert native.id_to_tok == py.id_to_tok


def test_native_trainer_equals_jax(text_file, tmp_path):
    counts = {"▁the": 80, "▁quick": 40, "▁ünïcode": 40, "▁dozen": 40,
              "▁quickly": 7, "▁cafe": 3}
    got = pnative.train_merges_native(counts, 40, 2)
    assert got == jnative.train_merges_native(counts, 40, 2) and got
    tabbed = tmp_path / "tabbed.tsv"              # words that hold a tab
    tabbed.write_text("\n".join(f"{i}.jpg\t{line}"
                                for i, line in enumerate(LINES)))
    for path in (text_file, str(tabbed)):
        fast = pbpe.train_bpe([path], 300, SPECIALS)
        slow = pbpe.train_bpe([path], 300, SPECIALS, use_native=False)
        want = jbpe.train_bpe([path], 300, SPECIALS)
        assert fast.vocab == slow.vocab == want.vocab
        assert fast.merges == slow.merges == [tuple(m) for m in want.merges]
    tp = TextProcessor()
    tp.train_tokenizer([text_file], 300, str(tmp_path / "tok"), {"<xx>": 0})
    loaded = TextProcessor(str(tmp_path / "tok"))
    assert isinstance(loaded.tokenizer, pnative.NativeBPE)
    assert loaded.tokenize_one_sentence("<xx> the lazy fox </s>") == (
        [loaded.token_id("<xx>")] + loaded.tokenizer.py.encode("the lazy fox")
        + [loaded.sep_token_id()])
    root = os.path.join(os.path.dirname(pnative.__file__), os.pardir,
                        "_build")
    assert os.path.realpath(build.LOADED["bpe"]).startswith(
        os.path.realpath(root))


def _image(path, shape, seed, **kw):
    rs = np.random.RandomState(seed)
    smooth = rs.randint(0, 255, (shape[0] // 16 + 1, shape[1] // 16 + 1)
                        + shape[2:], np.uint8)
    arr = np.kron(smooth, np.ones((16, 16) + (1,) * (len(shape) - 2),
                                  np.uint8))[:shape[0], :shape[1]]
    arr = np.clip(arr.astype(int) + rs.randint(-20, 20, arr.shape), 0, 255)
    Image.fromarray(arr.astype(np.uint8)).save(path, **kw)
    return str(path)


@pytest.mark.parametrize("kw", [dict(), dict(size=96), dict(raw=True),
                                dict(size=224, resize_min=300, raw=True)])
def test_load_image_equals_jax_default_path(tmp_path, monkeypatch, kw):
    big = _image(tmp_path / "big.jpg", (1024, 1280, 3), 1, quality=90)
    gray = _image(tmp_path / "gray.jpg", (480, 640), 2, quality=90)
    png = _image(tmp_path / "img.png", (300, 500, 3), 3)
    size = kw.get("size", 224)
    resize_min = kw.get("resize_min", max(256, size))
    assert pdec.FAST_DCT_SCALE and jdec.FAST_DCT_SCALE
    # The prescale engages on the large JPEG: its pixels are not those of a
    # full-resolution decode (or of Pillow).
    u8, denom = pdec.decode_resize_info(big, size, resize_min)
    assert denom > 1
    assert denom == jdec.decode_resize_info(big, size, resize_min)[1]
    full = pdec.decode_resize(big, size, resize_min, fast_scale=False)
    assert not np.array_equal(u8, full)
    for path in (big, gray, png):
        got = pimages.load_image(path, **kw)
        want = jimages.load_image(path, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    assert pdec.decode_resize(png) is None         # Pillow decodes a PNG
    # Pillow alone (the port's decode before the native path) gives other
    # pixels than the JAX package's default on the large JPEG.
    monkeypatch.setattr(pimages, "decode_resize", lambda *a, **k: None)
    assert not np.array_equal(pimages.load_image(big, **kw),
                              jimages.load_image(big, **kw))


def test_decoder_fallbacks(tmp_path):
    assert pdec.get_lib() is not None
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg at all")
    assert pdec.decode_resize(str(bad)) is None
    assert pdec.decode_resize(str(tmp_path / "missing.jpg")) is None
    good = _image(tmp_path / "good.jpg", (480, 640, 3), 4, quality=90)
    data = open(good, "rb").read()
    trunc = tmp_path / "trunc.jpg"
    trunc.write_bytes(data[: len(data) // 3])
    assert pdec.decode_resize(str(trunc)) is None
    garbage = tmp_path / "garbage.jpg"
    garbage.write_bytes(b"\xff\xd8garbage")
    for path in (trunc, garbage, bad):
        black = pimages.load_image(str(path), raw=True)
        assert black.shape == (224, 224, 3) and black.max() == 0
        assert np.array_equal(black, jimages.load_image(str(path), raw=True))
    assert pdec.decode_resize(good, 224, 128) is None   # size > resize_min
    assert build.has_header("jpeglib.h")
    assert "imagedec" in build.LOADED
