"""The port's ITR1 record format (``data/recordio.py``) against the JAX
package's, through the C library and through the numpy path:

- the writers give the JAX package's bytes for MT pairs, MASS shards,
  document blocks and captions (+ ``.paths.json``), and the numpy path the
  C library's;
- each package reads the other's files (``load_mt``, ``load_mass``,
  ``DocBlockDataset``, ``load_caption_bin``);
- ``MTBatcher.from_packed`` and ``MassBatcher.from_packed`` give the JAX
  package's batches, and the list batcher's for the same examples;
- corrupt files raise OSError at open in both packages, empty fields read
  back, fields outlive their reader, and a writer left on an exception
  removes its temporary file and writes nothing;
- the five ``--packed`` CLIs write the JAX CLIs' bytes, and
  ``cli.train_mt`` builds the same batches from ITR1 files as from marshal.
"""

import json
import os

import numpy as np
import pytest

from imagetranslate_tpu.cli import binarize_captions_from_list as jcap_list
from imagetranslate_tpu.cli import binarize_coco_data as jcoco
from imagetranslate_tpu.cli import binarize_image_caption_data as jwiki
from imagetranslate_tpu.cli import create_batches as jcreate_batches
from imagetranslate_tpu.cli import create_mt_batches as jcreate_mt
from imagetranslate_tpu.data import binarize as jbin
from imagetranslate_tpu.data import binarize_captions as jbincap
from imagetranslate_tpu.data import images as jimages
from imagetranslate_tpu.data import loader as jloader
from imagetranslate_tpu.data import recordio as jrec
from imagetranslate_tpu.text.processor import TextProcessor as JaxTP
from imagetranslate_tpu_torch.cli import binarize_captions_from_list
from imagetranslate_tpu_torch.cli import binarize_coco_data
from imagetranslate_tpu_torch.cli import binarize_image_caption_data
from imagetranslate_tpu_torch.cli import create_batches, create_mt_batches
from imagetranslate_tpu_torch.data import binarize as pbin
from imagetranslate_tpu_torch.data import binarize_captions as pbincap
from imagetranslate_tpu_torch.data import images as pimages
from imagetranslate_tpu_torch.data import loader as ploader
from imagetranslate_tpu_torch.data import recordio as prec
from imagetranslate_tpu_torch.text.processor import TextProcessor

WORDS = ["alpha", "beta", "gamma", "delta", "epsi", "zeta", "theta", "iota",
         "kappa", "lambda", "mu"]
MODES = ["native", "numpy"]


def _sentence(rng, n):
    return " ".join(WORDS[j] for j in rng.randint(0, len(WORDS), n))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A two-language tokenizer, parallel and monolingual text, documents, a
    caption list, a COCO JSON and wiki documents (images unchecked)."""
    d = tmp_path_factory.mktemp("itr1")
    rng = np.random.RandomState(0)
    src = [_sentence(rng, rng.randint(1, 30)) for _ in range(90)]
    dst = [_sentence(rng, rng.randint(1, 30)) for _ in range(90)]
    (d / "src.txt").write_text("\n".join(src) + "\n")
    (d / "dst.txt").write_text("\n".join(dst) + "\n")
    docs = [" ".join(f"<aa> {_sentence(rng, rng.randint(3, 12))} </s>"
                     for _ in range(rng.randint(1, 6))) for _ in range(20)]
    (d / "docs.txt").write_text("\n".join(docs) + "\n")
    (d / "all.txt").write_text("\n".join(src + dst) + "\n")
    TextProcessor().train_tokenizer([str(d / "all.txt")], 90, str(d / "tok"),
                                    {"<aa>": 0, "<bb>": 1, "<en>": 2})
    (d / "caps.tsv").write_text("".join(
        f"img{i % 7}.jpg\t{_sentence(rng, rng.randint(2, 12))}\n"
        for i in range(30)))
    coco = {"annotations": [{"image_id": 100 + i % 5,
                             "caption": _sentence(rng, rng.randint(2, 9))}
                            for i in range(20)]}
    (d / "coco.json").write_text(json.dumps(coco))
    wiki = [{"content": "<en> " + " </s> ".join(
                _sentence(rng, rng.randint(3, 9)) for _ in range(4)),
             "images": [{"img_path": f"w{k}_{j}.jpg",
                         "caption": f"<en> {_sentence(rng, 4)} </s>"}
                        for j in range(2)]} for k in range(4)]
    (d / "wiki.json").write_text(json.dumps(wiki))
    return d


def _tps(d):
    return TextProcessor(str(d / "tok")), JaxTP(str(d / "tok"))


def _mode(monkeypatch, mode):
    """Both packages on the C library or on the numpy path."""
    if mode == "numpy":
        monkeypatch.setattr(prec, "get_lib", lambda: None)
        monkeypatch.setattr(jrec, "_lib", None)
        monkeypatch.setattr(jrec, "_lib_tried", True)
    else:
        assert prec.get_lib() is not None and jrec.get_lib() is not None


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _write(kind, tp, jax_side, d, out):
    """Write ``kind`` with one package into ``out`` (a directory)."""
    os.makedirs(out, exist_ok=True)
    bin_, bincap = (jbin, jbincap) if jax_side else (pbin, pbincap)
    aa, bb = tp.token_id("<aa>"), tp.token_id("<bb>")
    if kind == "mt":
        bin_.write_mt(tp, f"{out}/p.mt", str(d / "src.txt"), aa,
                      str(d / "dst.txt"), bb, max_len=24, packed=True)
    elif kind == "mass":
        bin_.write_mt(tp, f"{out}/mono", str(d / "src.txt"), aa,
                      shard_size=40, packed=True)
    elif kind == "docs":
        bin_.write_doc_blocks(tp, str(d / "docs.txt"), f"{out}/blocks",
                              seq_len=16, sen_block_size=7, packed=True)
    else:
        bincap.write_from_list(tp, f"{out}/caps.bin", str(d / "caps.tsv"),
                               lang="en", packed=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["mt", "mass", "docs", "captions"])
def test_writers_give_jax_bytes(corpus, tmp_path, monkeypatch, kind, mode):
    tp, jtp = _tps(corpus)
    _write(kind, jtp, True, corpus, str(tmp_path / "jax_native"))
    _mode(monkeypatch, mode)
    _write(kind, tp, False, corpus, str(tmp_path / "port"))
    _write(kind, jtp, True, corpus, str(tmp_path / "jax"))
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert got == want == _tree(str(tmp_path / "jax_native"))
    packed = [n for n in got if not n.endswith((".json", ".txt"))]
    assert packed and all(got[n][:4] == b"ITR1" for n in packed)
    assert not any(n.endswith(".tmp") for n in got)


def _eq(a, b):
    """Records equal field by field (arrays or ints)."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for fa, fb in zip(ra, rb):
            assert np.array_equal(np.asarray(fa), np.asarray(fb))


def test_each_package_reads_the_others_files(corpus, tmp_path):
    tp, jtp = _tps(corpus)
    for jax_side, name in ((True, "j"), (False, "p")):
        for kind in ("mt", "mass", "docs", "captions"):
            _write(kind, jtp if jax_side else tp, jax_side, corpus,
                   str(tmp_path / name))
    for name in ("j", "p"):
        d = tmp_path / name
        _eq(pbin.load_mt(str(d / "p.mt")), jbin.load_mt(str(d / "p.mt")))
        _eq(pbin.load_mass(str(d / "mono")), jbin.load_mass(str(d / "mono")))
        assert len(pbin.load_mass(str(d / "mono"))) == 90
        got = pimages.load_caption_bin(str(d / "caps.bin"))
        assert got == jimages.load_caption_bin(str(d / "caps.bin"))
        ds = ploader.DocBlockDataset(str(d / "blocks"), max_cache_size=1)
        jds = jloader.DocBlockDataset(str(d / "blocks"), max_cache_size=1)
        assert len(ds) == len(jds) > 7
        for i in range(len(ds)):
            assert ds[i] == list(jds[i]) and ds.lang_at(i) == jds.lang_at(i)
    # The packed files hold what the marshal files hold.
    pbin.write_mt(tp, str(tmp_path / "m.mt"), str(corpus / "src.txt"),
                  tp.token_id("<aa>"), str(corpus / "dst.txt"),
                  tp.token_id("<bb>"), max_len=24)
    _eq(pbin.load_mt(str(tmp_path / "p" / "p.mt")),
        pbin.load_mt(str(tmp_path / "m.mt")))


def _fields(b, names):
    return [getattr(b, n) for n in names]


MT_FIELDS = ("src", "src_mask", "dst", "dst_mask", "src_langs", "dst_langs",
             "src_sizes", "row_mask", "proposals", "proposal_mask")
MASS_FIELDS = ("src", "src_mask", "langs", "lang_tokens", "lengths",
               "row_mask")


def _same_batches(got, want, names):
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        for name, a, b in zip(names, _fields(g, names), _fields(w, names)):
            if b is None:
                assert a is None, name
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("mode", MODES)
def test_from_packed_batches_equal_jax(corpus, tmp_path, monkeypatch, mode):
    tp, jtp = _tps(corpus)
    _mode(monkeypatch, mode)
    _write("mt", tp, False, corpus, str(tmp_path))
    _write("mass", tp, False, corpus, str(tmp_path))
    lex = {tp.token_id("<aa>"): [7, 9], 11: [12]}
    kw = dict(pad_id=0, max_batch=300, capacity_mb=1, max_seq_len=20,
              lex_dict=lex)
    path = str(tmp_path / "p.mt")
    got = ploader.MTBatcher.from_packed(prec.PackedReader(path), **kw)
    want = jloader.MTBatcher.from_packed(jrec.PackedReader(path), **kw)
    _same_batches(got.batches, want.batches, MT_FIELDS)
    _same_batches(got.batches,
                  ploader.MTBatcher(pbin.load_mt(path), **kw).batches,
                  MT_FIELDS)
    kw = dict(pad_id=0, max_batch=200, capacity_mb=1, max_seq_len=24)
    for shard in sorted(os.listdir(tmp_path)):
        if not shard.startswith("mono."):
            continue
        path = str(tmp_path / shard)
        got = ploader.MassBatcher.from_packed(prec.PackedReader(path), **kw)
        want = jloader.MassBatcher.from_packed(jrec.PackedReader(path), **kw)
        _same_batches(got.batches, want.batches, MASS_FIELDS)
        _same_batches(got.batches, ploader.MassBatcher(
            pbin.load_mass(path), **kw).batches, MASS_FIELDS)


def _corruptions(good, out):
    """(name, path) of corrupt ITR1 files made from ``good``."""
    blob = bytearray(good.read_bytes())

    def set_u64(b, off, v):
        b[off:off + 8] = np.uint64(v).tobytes()

    def swap_index(b):
        a = b[24:32]
        b[24:32] = b[32:40]
        b[32:40] = a

    for name, mutate in (
            ("huge_n", lambda b: set_u64(b, 8, 2 ** 48)),
            ("overflow_nf", lambda b: set_u64(b, 8, 2 ** 62)),
            ("zero_fields", lambda b: b.__setitem__(
                slice(4, 8), np.uint32(0).tobytes())),
            ("truncated", lambda b: b.__delitem__(slice(len(b) // 2, None))),
            ("truncated_header", lambda b: b.__delitem__(slice(11, None))),
            ("nonmonotonic", swap_index),
            ("oob_offset", lambda b: set_u64(b, 24, 2 ** 40))):
        b = bytearray(blob)
        mutate(b)
        path = out / f"{name}.itr"
        path.write_bytes(bytes(b))
        yield name, path


@pytest.mark.parametrize("mode", MODES)
def test_corrupt_files_refused_and_edge_cases(tmp_path, monkeypatch, mode):
    _mode(monkeypatch, mode)
    good = tmp_path / "good.itr"
    with prec.PackedWriter(str(good), 2) as w:
        w.add([], 7)
        w.add([1, 2, 3], 8)
        w.add(np.arange(5), 9)
    for name, path in _corruptions(good, tmp_path):
        for reader in (prec.PackedReader, jrec.PackedReader):
            with pytest.raises(OSError, match="ITR1"):
                reader(str(path))
    assert not prec.is_packed(str(tmp_path / "missing"))
    r = prec.PackedReader(str(good))
    assert r.native == (mode == "native")
    assert r.field(0, 0).size == 0 and r.field_view(0, 0).size == 0
    assert r.lengths(0).tolist() == [0, 3, 5]
    assert r.scalars(1).tolist() == [7, 8, 9]
    assert r.pack_padded([2, 0, 1], 0, 4, -1).tolist() == [
        [0, 1, 2, 3], [-1, -1, -1, -1], [1, 2, 3, -1]]
    kept = r.field(2, 0)
    view = prec.PackedTupleView(r, scalar_fields=(1,))
    assert [(f.tolist(), s) for f, s in view] == [
        ([], 7), ([1, 2, 3], 8), ([0, 1, 2, 3, 4], 9)]
    del r, view
    assert kept.tolist() == [0, 1, 2, 3, 4]      # outlives the reader
    # Leaving a with block on an exception writes nothing.
    with pytest.raises(RuntimeError):
        with prec.PackedWriter(str(tmp_path / "aborted.itr"), 1) as w:
            w.add([1, 2])
            raise RuntimeError("stop")
    assert not any(n.startswith("aborted") for n in os.listdir(tmp_path))


def _cli_args(d, kind, out):
    tok = ["--tok", str(d / "tok")]
    if kind == "create_mt_batches":
        return tok + ["--src", str(d / "src.txt"), "--src-lang", "aa",
                      "--dst", str(d / "dst.txt"), "--dst-lang", "bb",
                      "--output", f"{out}/train.mt", "--packed"]
    if kind == "create_mt_batches_mono":
        return tok + ["--src", str(d / "src.txt"), "--src-lang", "aa",
                      "--output", f"{out}/mono", "--packed"]
    if kind == "create_batches":
        return tok + ["--data", str(d / "docs.txt"), "--cache",
                      f"{out}/blocks", "--seq_len", "16", "--block", "9",
                      "--packed"]
    files = {"binarize_captions_from_list": ("caps.tsv", ["--lang", "en"]),
             "binarize_coco_data": ("coco.json", []),
             "binarize_image_caption_data": ("wiki.json", [])}
    name, extra = files[kind]
    return tok + ["--file", str(d / name), "--output", f"{out}/caps.bin",
                  "--packed"] + extra


CLIS = {
    "create_mt_batches": (create_mt_batches, jcreate_mt),
    "create_mt_batches_mono": (create_mt_batches, jcreate_mt),
    "create_batches": (create_batches, jcreate_batches),
    "binarize_captions_from_list": (binarize_captions_from_list, jcap_list),
    "binarize_coco_data": (binarize_coco_data, jcoco),
    "binarize_image_caption_data": (binarize_image_caption_data, jwiki),
}


@pytest.mark.parametrize("kind", sorted(CLIS))
def test_packed_clis_byte_for_byte(corpus, tmp_path, kind):
    port, jax_cli = CLIS[kind]
    for name, mod in (("port", port), ("jax", jax_cli)):
        out = tmp_path / name
        out.mkdir()
        mod.main(_cli_args(corpus, kind, str(out)))
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert got == want and got
    assert all(v[:4] == b"ITR1" for n, v in got.items()
               if not n.endswith((".json", ".txt")))


def test_train_mt_batches_from_itr1(corpus, tmp_path, capsys):
    """cli.train_mt on an ITR1 .mt file builds as many batches as on the
    marshal file of the same text; ITR1 MASS shards batch one shard at a
    time, as in the JAX CLI (no step)."""
    from imagetranslate_tpu_torch.cli import train_mt

    tp, _ = _tps(corpus)
    counts = {}
    for packed in (False, True):
        out = tmp_path / ("p" if packed else "m")
        out.mkdir()
        pbin.write_mt(tp, str(out / "t.mt"), str(corpus / "src.txt"),
                      tp.token_id("<aa>"), str(corpus / "dst.txt"),
                      tp.token_id("<bb>"), packed=packed)
        pbin.write_mt(tp, str(out / "mono"), str(corpus / "src.txt"),
                      tp.token_id("<aa>"), shard_size=40, packed=packed)
        capsys.readouterr()
        train_mt.main(["--tok", str(corpus / "tok"), "--model",
                       str(out / "model"), "--train_mt", str(out / "t.mt"),
                       "--mass_train", str(out / "mono"), "--batch", "400",
                       "--embed", "24", "--intermediate", "32", "--enc", "1",
                       "--dec", "1", "--step", "0", "--device", "cpu"])
        counts[packed] = [ln for ln in capsys.readouterr().out.splitlines()
                          if "train batches" in ln]
    assert counts[True][0] == counts[False][0]
    shards = sorted((tmp_path / "p").glob("mono.*"))
    assert len(shards) == 3
    per_shard = sum(len(ploader.MassBatcher(pbin.load_mass(str(s)),
                                            max_batch=400, capacity_mb=600,
                                            max_seq_len=175))
                    for s in shards)
    assert counts[True][1] == f"MASS train batches: {per_shard}"
    assert counts[False][1] == "MASS train batches: " + str(len(
        ploader.MassBatcher(pbin.load_mass(str(tmp_path / "m" / "mono")),
                            max_batch=400, capacity_mb=600,
                            max_seq_len=175)))
