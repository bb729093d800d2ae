"""The port's corpus-mining toolbox (``comparable/``'s host tools,
``scripts/`` with its four subfolders and ``mmid/``'s two extractors)
against the JAX package's, byte for byte.

Each case runs the JAX tool's ``main()`` and the port's ``main()`` in this
process with the same argv, on generated inputs that cover the tool's
branches, and compares the files each writes (every file under its output
directory, links by target) and its stdout, with the output directory's
path replaced by a placeholder. One process gives both sides the same hash
seed, which the set-order tools need; the shuffling tools get the same
``random`` seed. Downloads go through one stub on both sides
(``urllib.request.urlretrieve`` and ``urlopen``, ``subprocess.run`` for
wget). Two more tests run a few port tools in a subprocess where jax, flax
and the JAX package cannot be imported, and check that every module of the
JAX package has a port counterpart at the same relative path.
"""

import contextlib
import importlib
import io
import json
import marshal
import os
import random
import subprocess
import sys
import textwrap
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {}


def case(module):
    """Registers ``fn(d) -> [argv(out_dir), ...]`` for ``module``: ``fn``
    writes the inputs into ``d`` and returns one argv builder a run."""
    def register(fn):
        CASES[module] = fn
        return fn
    return register


def lines(path, rows):
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def doc(lang, sents, imgs):
    return {"content": f"<{lang}> " + " </s> ".join(sents) + " </s>",
            "lang": lang,
            "images": [{"img_path": p,
                        "caption": f"<{lang}> caption about {p} here now </s>"}
                       for p in imgs]}


# ---------------- comparable/ ----------------

@case("comparable.enrich_dict_with_other_dict")
def _(d):
    a = lines(d / "a", ["haus\thouse", "hund\tdog", "bad", "katze\tcat"])
    b = lines(d / "b", ["haus\thome", "baum\ttree", "maus\tdog", "x",
                        "blume\tflower\textra"])
    return [lambda o: [a, b, o / "out"]]


@case("comparable.extract_best_comparable")
def _(d):
    rows = [("the cat sits", "le chat est assis", 2.4),
            ("the cat sits", "un chien", 1.0),
            ("a dog", "un chien", 1.9),
            ("a dog", "le chien court vite la", 2.0),
            ("tiny", "mini", 0.05),
            ("same norm", "meme norme", 1.2)]
    s = lines(d / "s", [r[0] for r in rows])
    t = lines(d / "t", [r[1] for r in rows])
    sc = lines(d / "sc", [str(r[2]) for r in rows])
    base = ["--src", s, "--dst", t, "--scores", sc]
    return [lambda o: base + ["--output", o / "out"],
            lambda o: base + ["--output", o / "out2", "--min", "0.5"]]


@case("comparable.extract_parallel_using_dict")
def _(d):
    dic = lines(d / "dict", ["der\tthe", "hund\tDog", "katze\tcat", "bad"])
    raw = ["Der Hund ||| The Dog", "der hund ||| the cat",
           "die Katze ||| the cat", "x ||| y", "only one side",
           "der katze ||| the dog"]
    pairs = lines(d / "pairs", raw)
    tok = lines(d / "tok", [r.lower() for r in raw])
    return [lambda o: [dic, pairs, tok, o / "out"]]


@case("comparable.filter_non_matched_numbers_from_parallel_data")
def _(d):
    rows = [("keep ||| a", "price ۱۲.۵ now", "cost 12.5 today"),
            ("drop ||| b", "has ४२", "has 43"),
            ("keep2 ||| c", "no digits", "none either"),
            ("keep3 ||| d", "twice 7 and 7", "just 7"),
            ("drop2 ||| e", "9 here", "none"),
            ("keep4 ||| f", "૧૨ and ٫5", "12 and .5")]
    p = lines(d / "p", [r[0] for r in rows])
    s = lines(d / "s", [r[1] for r in rows])
    t = lines(d / "t", [r[2] for r in rows])
    return [lambda o: [p, s, t, o / "out"]]


# ---------------- mmid/ ----------------

@case("mmid.extract_best_mmid_trans")
def _(d):
    for sub, word in (("f/gato", "gato"), ("f/perro", "perro"),
                      ("e/cat", "cat"), ("e/dog", "dog"), ("e/pup", "dog")):
        (d / sub).mkdir(parents=True)
        (d / sub / "word.txt").write_text(word + "\n")
    rows = ["f/gato\te/cat\t0.9", "f/gato\te/dog\t0.5",
            "f/perro\te/dog\t0.8", f"{d}/f/perro\t{d}/e/pup\t0.85",
            "f/perro\te/cat\t0.95", "f/missing\te/cat\t0.99", "bad\tline"]
    sims = lines(d / "sims", rows)
    return [lambda o: ["--input", sims, "--root", str(d), "--output",
                       o / "dict"]]


@case("mmid.extract_dict_common_w_fasttext")
def _(d):
    se = lines(d / "se", ["2 3", "gato 0.1 0.2", "Perro 0.3 0.4",
                          "casa 0.5 0.6"])
    ee = lines(d / "ee", ["cat 0.1 0.2", "dog 0.3 0.4", "home 0 0"])
    dic = lines(d / "dict", ["gato\tcat\tkitty", "Perro\tDog",
                             "CASA\tHome\thouse", "nada\tnothing"])
    return [lambda o: [se, ee, dic, o / "out"]]


# ---------------- scripts/ ----------------

@case("scripts.add_lang_id")
def _(d):
    inp = lines(d / "in", ["hello there world", "  a b ", "", "single"])
    return [lambda o: [inp, "kk", o / "out"]]


@case("scripts.align2fastalign")
def _(d):
    a = lines(d / "a", ["Hello World", "x", "Fine Line", ""])
    b = lines(d / "b", ["Bonjour Monde", "yy", "z", "ok ok"])
    return [lambda o: [a, b, o / "out"]]


@case("scripts.build_alignment_dict")
def _(d):
    from imagetranslate_tpu.text.processor import TextProcessor

    corpus = d / "c.txt"
    corpus.write_text("ha he hi ho hu " * 30)
    tok = str(d / "tok")
    TextProcessor().train_tokenizer([str(corpus)], 60, tok, {"<xx>": 0})
    s = lines(d / "s", ["<mask> <pad>", "<mask>", "<unk> <mask>", "ha he"])
    t = lines(d / "t", ["<s> <unk>", "</s>", "<pad> <s>", "hi ho"])
    a = lines(d / "a", ["0-0 1-1", "0-0", "0-0 1-1 x 1-9", "0-1 1-0"])
    return [lambda o: ["--src", s, "--dst", t, "--align", a, "--tok", tok,
                       "--output", o / "out"]]


@case("scripts.coco_json_to_list")
def _(d):
    ann = [{"image_id": 42, "caption": "a cat\non a mat\r\n"},
           {"image_id": 7, "caption": "  padded  "},
           {"image_id": 42, "caption": "second caption"}]
    (d / "c.json").write_text(json.dumps({"annotations": ann}))
    return [lambda o: [d / "c.json", d / "imgs", o / "out"]]


@case("scripts.count_shared_words")
def _(d):
    a = lines(d / "a", ["the cat sat", "the dog ran"])
    b = lines(d / "b", ["a cat runs", "the bird sat still"])
    return [lambda o: [a, b]]


@case("scripts.count_unique_sens")
def _(d):
    return [lambda o: [lines(d / "in", ["a", "b", "a", "c", "b"])]]


@case("scripts.count_wiki_json_stat")
def _(d):
    (d / "a.json").write_text(json.dumps(
        [doc("fa", ["x y z", "p q"], ["i1.jpg", "i2.jpg"]),
         doc("fa", ["solo sen"], ["i3.jpg"])]))
    (d / "b.json").write_text(json.dumps(
        [doc("en", ["one two"], ["i2.jpg", "i9.jpg"])]))
    return [lambda o: [d / "a.json", d / "b.json"]]


@case("scripts.count_wiki_stats")
def _(d):
    return [lambda o: [lines(d / "in", ["<fa> a b </s> c </s>", "",
                                        "<en> x y z </s>  </s>"])]]


@case("scripts.create_caption_list_from_translation")
def _(d):
    tr = lines(d / "tr", ["a red cat ||| eine rote katze",
                          "a dog ||| ein hund", "a dog ||| ein zweiter hund",
                          "no separator"])
    caps = lines(d / "caps", ["img1.jpg\ta red cat",
                              "img2.jpg\tuntranslated one",
                              "img3.jpg\ta dog", "malformed-no-tab"])
    return [lambda o: [tr, caps, o / "out"]]


def _caption_tsvs(d):
    refs = lines(d / "ref.tsv", [
        "a/b/img1.jpg\ta red cat sits", "img1.jpg\tthe red cat is sitting",
        "c/img2.jpg\ta dog runs fast", "img3.jpg\tbirds fly high",
        "img3.jpg\tthe birds are flying", "img3.jpg\tbirds in the sky",
        "malformed-line-no-tab"])
    hyps = lines(d / "hyp.tsv", ["x/img1.jpg\ta red cat sits",
                                 "img2.jpg\tthe dog runs",
                                 "y/z/img3.jpg\tbirds fly in the sky",
                                 "bad"])
    return [lambda o: [refs, hyps]]


@case("scripts.eval_caption_bleu")
def _(d):
    pytest.importorskip("sacrebleu")
    return _caption_tsvs(d)


@case("scripts.eval_caption_sacre")
def _(d):
    pytest.importorskip("sacrebleu")
    return _caption_tsvs(d)


@case("scripts.eval_sacre_bleu")
def _(d):
    pytest.importorskip("sacrebleu")
    hyp = lines(d / "hyp", ["the cat sat on the mat", "a quick brown fox",
                            "Hello world"])
    r1 = lines(d / "r1", ["the cat sat on a mat", "the quick brown fox",
                          "hello world"])
    r2 = lines(d / "r2", ["a cat sat on the mat", "a quick brown fox !",
                          "hello , world"])
    return [lambda o: ["--output", hyp, "--gold", f"{r1},{r2}"],
            lambda o: ["--output", hyp, "--gold", r1]]


def _alignment_pairs(d):
    p = lines(d / "p", ["der hund ||| the dog", "der hund lief ||| the dog ran",
                        "die katze ||| the cat", "der mann ||| the man",
                        "bad zeile ||| short line", "no separator here",
                        "gleich ||| Gleich"])
    a = lines(d / "a", ["0-0 1-1", "0-0 1-1 2-2", "0-0 1-2", "0-0 1-1",
                        "0-0 1-9 0-1", "0-0", "0-0"])
    return [lambda o: [p, a, o / "dict"]]


@case("scripts.extract_alignment_dict")
def _(d):
    return _alignment_pairs(d)


def _dense(d):
    rows = [("a b c d e", "v w x y z", "0-0 1-1 2-2 3-3"),
            ("a b c d e", "v w x y z", "0-0"),
            ("a b", "v w", "0-0 1-1"),
            ("a b c d e f g h i j k l", "v w x y z", "0-0 1-1 2-2 3-3 4-4"),
            ("a b c d e f", "v w x y z u t", "0-0 1-1 2-2 3-3 4-4 5-5")]
    s = lines(d / "s", [r[0] for r in rows])
    t = lines(d / "t", [r[1] for r in rows])
    a = lines(d / "a", [r[2] for r in rows])
    return [lambda o: [s, t, a, "0.5", o / "out"]]


@case("scripts.extract_dense_alignments")
def _(d):
    return _dense(d)


@case("scripts.extract_parallel_based_on_length_limit")
def _(d):
    pairs = [("a b c", "x y"), ("a", "x y z"), ("a b c d e f", "x y"),
             ("p q r s", "u v w")]
    s = lines(d / "s", [p[0] for p in pairs])
    t = lines(d / "t", [p[1] for p in pairs])
    return [lambda o: [s, t, "2", "5", o / "s", o / "t"]]


@case("scripts.extract_pmi_from_comparable")
def _(d):
    p = lines(d / "p", ["the cat ||| le chat", "the dog ||| le chien",
                        "The Cat sat ||| le chat assis", "bad line",
                        "a cat ||| un chat", "the the ||| le le"])
    return [lambda o: [p, o / "out", "1"], lambda o: [p, o / "out3"]]


@case("scripts.extract_sens_based_on_length_limit")
def _(d):
    inp = lines(d / "in", ["a b c", "a", "a b c d e f", " p q r s "])
    return [lambda o: [inp, "2", "4", o / "out"]]


@case("scripts.extract_sens_from_docs")
def _(d):
    (d / "in").write_text(
        "<fa> one two three </s> four five six seven </s> too long "
        + "x " * 30 + "</s>\n\n<en> just right here </s> no </s>\n"
        "<en> no </s>\n")
    return [lambda o: [d / "in", "3", "8", o / "out"]]


@case("scripts.extract_sens_from_img_docs")
def _(d):
    docs = [{"content": "<fa> one two three </s> no </s>",
             "images": [{"img_path": "a.jpg", "caption": "c"}]},
            {"content": "<fa> imageless doc sentence here </s>",
             "images": []},
            {"content": "<en> no </s>",
             "images": [{"img_path": "b.jpg", "caption": "c"}]}]
    (d / "d.json").write_text(json.dumps(docs))
    return [lambda o: [d / "d.json", "3", "10", o / "out"]]


@case("scripts.extract_translation_candidates")
def _(d):
    long_sen = " ".join(["w"] * 300)
    ref_docs = [doc("en", ["the big cat sat on the mat",
                           "five words here right now", long_sen],
                    ["a.jpg", "b.jpg"]),
                doc("en", ["unshared doc sentence here now"], ["z.jpg"])]
    src_docs = [doc("fa", ["one two three four five six",
                           "an exactly seven word long sentence here"],
                    ["a.jpg"]),
                doc("fa", ["short only"], ["b.jpg"]),
                doc("fa", ["no shared images here at all"], ["q.jpg"])]
    (d / "src.json").write_text(json.dumps(src_docs))
    (d / "ref.json").write_text(json.dumps(ref_docs))
    base = ["--file", d / "src.json", "--ref", d / "ref.json"]
    return [lambda o: base + ["--output", o / "txt", "--txt"],
            lambda o: base + ["--output", o / "bin"],
            lambda o: base + ["--output", o / "img", "--image"]]


@case("scripts.extract_translation_cands_from_comparable_output")
def _(d):
    rows = ["<en> a b\t<fa> x y\t-3.5", "<fa> x y\t<en> a b\t-4.0",
            "<en> c d\t<fa> z\t-9", "<fa> z\t<en> c d\t-9",
            "<en> e\t<fa> w\t-1", "<fa> w\t<en> E\t-1", "<fa> q\t<en> r\t-1",
            "<en> r\t<fa> q\t-1", "bad\tline"]
    inp = lines(d / "in", rows)
    return [lambda o: [inp, o / "out"], lambda o: [inp, o / "out2", "-20"]]


@case("scripts.extract_translation_from_output")
def _(d):
    inp = lines(d / "in", [f"line {i} kind {(i % 6) + 1}"
                           for i in range(6 * 7 + 3)])
    return [lambda o: [inp, o / "pre"]]


@case("scripts.fastalign2align")
def _(d):
    inp = lines(d / "in", ["a b ||| x y", "malformed", "p ||| q ||| r"])
    return [lambda o: [inp, o / "s", o / "d"]]


@case("scripts.fastalign_comp2align")
def _(d):
    inp = lines(d / "in", ["a b ||| x y", "title ||| t", "s ||| c1 ||| c2 ",
                           "bad"])
    return [lambda o: [inp, o / "s", o / "d"],
            lambda o: [inp, o / "s2", o / "d2", "skip"]]


@case("scripts.filter_bt_data")
def _(d):
    pairs = [("keep this one .", "garde celui ci"), ("why not ?", "pourquoi pas"),
             ("wow !", "ouah"), ("has 12 numbers 3", "a 12 nombres 3"),
             ("has 12 numbers", "a 13 nombres"), ("digit 5 here", "none here"),
             ("a b c d e f g h i j", "a b"), ("plain pair", "paire simple"),
             ("ends already .", "finit deja .")]
    s = lines(d / "s", [p[0] for p in pairs])
    t = lines(d / "t", [p[1] for p in pairs])
    return [lambda o: [s, t, "en", o / "en"], lambda o: [s, t, "ar", o / "ar"]]


@case("scripts.get_coco_captions")
def _(d):
    ann = [{"image_id": 42, "caption": " a cat "}, {"image_id": 7,
                                                     "caption": "dog"},
           {"image_id": 42, "caption": "second"}]
    (d / "c.json").write_text(json.dumps({"annotations": ann}))
    return [lambda o: [d / "c.json", d / "imgs", o / "out"]]


@case("scripts.get_txt_stat")
def _(d):
    return [lambda o: [lines(d / "in", ["<fa> one two three </s>",
                                        "plain untagged line",
                                        "<en> a b </s>"])]]


@case("scripts.mmiddict2parallel")
def _(d):
    dic = lines(d / "d", ["haus\thouse\thome\tdwelling", "ab\tx\tlongword",
                          "a\thouse", "tier\tanimal"])
    return [lambda o: [dic, o / "s", o / "d"]]


@case("scripts.remove_lang_id_from_txt")
def _(d):
    inp = lines(d / "in", ["<kk> hello there world </s>", "<kk> a </s>",
                           "x"])
    return [lambda o: [inp, o / "out"]]


@case("scripts.remove_punctuation")
def _(d):
    (d / "in").write_text("hello, world! (really)\nwhat؟ yes؛ sure،\n"
                          "keep+plus =equals\na\\b back\\slash\n")
    return [lambda o: [d / "in", o / "out"]]


@case("scripts.round_embedding_values")
def _(d):
    inp = lines(d / "in", ["word 0.123456 -1.999999 2.0 3.14159e-05",
                           "other 0.5 -0.00004"])
    return [lambda o: [inp, o / "out"]]


@case("scripts.sample_balanced_raw_texts")
def _(d):
    (d / "a.json").write_text(json.dumps(
        [doc("fa", ["x y z"], ["i1.jpg"]), doc("fa", ["p q"], [])]))
    (d / "b.json").write_text(json.dumps([doc("en", ["one two"], ["i2.jpg"])]))
    r1 = lines(d / "r1", [f"fa line {i}" for i in range(12)]
               + ["<fa> x y z </s>", ""])
    r2 = lines(d / "r2", [f"en line {i}" for i in range(7)])
    base = ["--l1j", d / "a.json", "--l2j", d / "b.json", "--l1r", r1,
            "--l2r", r2]
    return [lambda o: base + ["--o1", o / "o1", "--o2", o / "o2"],
            lambda o: base + ["--o1", o / "p1", "--o2", o / "p2",
                              "--min_doc", "3"]]


@case("scripts.sample_image_bin")
def _(d):
    images = {i: f"/imgs/{i}.jpg" for i in range(6)}
    captions = [(0, [1, 2, 3]), (2, [4, 5]), (0, [6]), (5, [7, 8]),
                (3, [9])]
    with open(d / "in.bin", "wb") as f:
        marshal.dump((images, captions), f)
    return [lambda o: [d / "in.bin", "3", o / "out.bin"],
            lambda o: [d / "in.bin", "10", o / "all.bin"]]


@case("scripts.sample_sentences")
def _(d):
    inp = lines(d / "in", [" ".join(["w"] * (i % 7 + 1)) + f" {i}"
                           for i in range(30)])
    return [lambda o: [inp, "5", "2", "5", o / "out"]]


@case("scripts.sort_based_on_len")
def _(d):
    inp = lines(d / "in", ["b b", "a", "c c c", "b b", "d d", "e",
                           "f f f f f", "g g g g", "x y z"])
    return [lambda o: [inp, o / "out", "1", "4"]]


@case("scripts.sort_dict")
def _(d):
    inp = lines(d / "in", ["haus\thouse\t0.9", "haus\thome\t0.95",
                           "hund\tdog\t0.8", "Same\tsame\t0.99",
                           "a.b\tdotted\t0.99", "x\ty\t0.05", "kurz\tk\t0.9",
                           "tie1\tfoo\t0.8", "two words\tzwei\t0.7",
                           "zwei worte\ttwo words\t0.6", "bad"])
    return [lambda o: [inp, o / "out", "0.1", "1"],
            lambda o: [inp, o / "out2", "0.1", "2"]]


@case("scripts.tab2fastalign")
def _(d):
    inp = lines(d / "in", ["a b\tx y", "no-tab-line", "c\tz w\t extra"])
    return [lambda o: [inp, o / "out"]]


# ---------------- scripts/flickr, gujarati ----------------

@case("scripts.flickr.create_train_dev_list")
def _(d):
    split = d / "split"
    split.mkdir()
    lines(split / "Flickr_8k.trainImages.txt", ["a.jpg", "b.jpg"])
    lines(split / "Flickr_8k.devImages.txt", ["c.jpg"])
    lines(split / "Flickr_8k.testImages.txt", ["d.jpg"])
    lines(split / "Flickr8k.arabic.full.txt",
          ["image\tcaption", "a.jpg#0\tقطة على", "c.jpg#1\tكلب",
           "z.jpg#0\tx"])
    caps = lines(d / "caps.csv", ["image,caption", "a.jpg,a cat, on a mat",
                                  "b.jpg,a dog", "d.jpg,test one",
                                  "q.jpg,nowhere"])
    return [lambda o: [caps, split, d / "imgs", o / "flickr"]]


@case("scripts.flickr.soft_link_images_to_folder")
def _(d):
    tsv = lines(d / "l.tsv", ["/data/a.jpg\tcap", "/data/a.jpg\tcap two",
                              "/other/b.jpg\tx", "bad"])
    return [lambda o: [tsv, o]]


@case("scripts.gujarati.convert2gujarati")
def _(d):
    (d / "in").write_text("नमस्ते दुनिया १२३\nlatin ॐ ऄ\n\n")
    return [lambda o: [d / "in", o / "out"]]


# ---------------- scripts/web_captions ----------------

_REAL_RUN = subprocess.run


def _wget_stub(cmd, *args, **kw):
    if cmd[0] != "wget":
        return _REAL_RUN(cmd, *args, **kw)
    url, out, log = cmd[cmd.index("-O") - 1], cmd[cmd.index("-O") + 1], \
        cmd[cmd.index("-o") + 1]
    with open(out, "w") as f:
        f.write("payload of " + url)
    with open(log, "a") as f:
        f.write(url + "\n")
    return subprocess.CompletedProcess(cmd, 0)


@case("scripts.web_captions.download_from_list")
def _(d):
    urls = lines(d / "urls", [f"http://example.invalid/{i}.jpg"
                              for i in range(6)])
    return [lambda o: [urls, o / "dl", "1", "4"]]


def _image_stub(url, path):
    from PIL import Image

    size = (300, 200) if "big" in url else (100, 90)
    Image.new("RGB", size, (len(url) % 255, 40, 90)).save(path)
    return path, None


@case("scripts.web_captions.download_images")
def _(d):
    pytest.importorskip("PIL")
    rows = ["a cat\thttp://x.invalid/big1.jpg?w=3", "tiny\thttp://x.invalid/s.png",
            "gif\thttp://x.invalid/big.gif", "no tab line",
            "bad\thttp://x.invalid/fail.jpeg", "dog\thttp://x.invalid/big2.JPEG",
            "late\thttp://x.invalid/big3.jpg"]
    lst = lines(d / "list", rows)
    return [lambda o: [lst, "1", "6", o / "imgs"]]


def _html_tree(d):
    pytest.importorskip("bs4")
    (d / "html" / "sub" / "deep").mkdir(parents=True)
    (d / "html" / "a.html").write_text(
        '<html><img src="x.jpg" alt="a long alt text here">'
        '<img src="y.jpg" alt="short"><img alt="no src at all here">'
        '<figure><img src="f.jpg"><figcaption>a figure caption with words'
        '</figcaption></figure><figcaption>orphan caption text is here'
        '</figcaption></html>')
    (d / "html" / "sub" / "b.htm").write_text(
        '<img src="z.png" alt="another image with a caption">')
    (d / "html" / "sub" / "deep" / "c.html").write_text(
        '<figure><img src="g.jpg"><figcaption>two words</figcaption></figure>')
    (d / "html" / "skip.txt").write_text('<img src="q.jpg" alt="not html '
                                         'file at all">')
    return [lambda o: [d / "html", o / "caps"],
            lambda o: [d / "html", o / "caps2", "2"]]


@case("scripts.web_captions.extract_caption_candidates_from_html_files")
def _(d):
    return _html_tree(d)


@case("scripts.web_captions.extract_caption_subfolders")
def _(d):
    return _html_tree(d)


@case("scripts.web_captions.filter_wiki_captions")
def _(d):
    tsv = lines(d / "c.tsv", ["a.jpg\t<en> a long caption here </s>",
                              "b.jpg\t<en> too short </s>",
                              "c.jpg\tplain caption of four words",
                              "d.jpg\t<fa> one two three four five </s>",
                              "bad line", "e.jpg\tx\ty"])
    return [lambda o: [tsv, o / "all"], lambda o: [tsv, o / "en", "en"]]


@case("scripts.web_captions.index2image_list")
def _(d):
    imgs = d / "imgs"
    imgs.mkdir()
    for name in ("one.jpg", "two.JPEG", "three"):
        (imgs / name).write_bytes(b"x")
    idx = lines(d / "idx", ["one\tcap one here", "two\tmeta\tcap two",
                            "three\tcap three", "missing\tno file"])
    return [lambda o: [idx, imgs, o / "out"]]


# ---------------- scripts/wiki ----------------

@case("scripts.wiki.extract_alignment_dict")
def _(d):
    return _alignment_pairs(d)


@case("scripts.wiki.extract_best_alignments_from_scores")
def _(d):
    w5 = "a b c d e"
    inp = lines(d / "in", [f"{w5}\t{w5} f\t0.5", f"{w5} x\t{w5}\t0.9",
                           f"a b\t{w5}\t0.99", f"{w5}\tq r s t u\t0.5",
                           "bad"])
    return [lambda o: [inp, o / "out"]]


@case("scripts.wiki.extract_clean_titles")
def _(d):
    inp = lines(d / "in", ["Paris\tپاریس", "Rome (city)\tرم", "a\tb\tc",
                           "Berlin\tبرلین (شهر)", "London\tلندن"])
    return [lambda o: [inp, o / "out"]]


@case("scripts.wiki.extract_comparable_from_captions")
def _(d):
    (d / "a.json").write_text(json.dumps(
        [doc("fa", ["x"], ["i1.jpg", "i2.jpg"]), doc("fa", ["y"], ["i1.jpg"]),
         doc("fa", ["z"], ["i7.jpg"])]))
    (d / "b.json").write_text(json.dumps(
        [doc("en", ["u"], ["i1.jpg", "i9.jpg"]), doc("en", ["v"],
                                                     ["i2.jpg"])]))
    return [lambda o: [d / "a.json", d / "b.json", o / "s", o / "t"]]


def _wiki_docs(d):
    titles = lines(d / "titles", ["پاریس (شهر)\tParis", "رم\tRome",
                                  "bad line", "برلین\tBerlin",
                                  "لندن\tLondon", "مادرید\tMadrid"])
    src = lines(d / "src", [
        "<fa> پاریس </s> پاریس پایتخت فرانسه است و بزرگ </s> "
        "در سال 1900 شهر بزرگ بود و زیبا </s>",
        "<fa> رم </s> رم شهری در ایتالیا است زیبا </s>",
        "<fa> برلین </s> berlin is the capital of germany </s>",
        "<fa> لندن </s> لندن ۱۲ شهری بزرگ است در انگلیس </s>",
        "<fa> مادرید </s>"])
    dst = lines(d / "dst", [
        "<en> Paris </s> Paris is the capital of () France and big </s> "
        "In 1900 the city was big and beautiful </s>",
        "<en> Rome </s> Rome is a city in Italy , very old </s>",
        "<en> Berlin </s> Berlin is the capital of Germany </s>",
        "<en> London </s> London 12 is a big city in England </s>",
        "<en> Madrid </s> Madrid is the capital of Spain ok </s>",
        "<en> Tokyo </s> Tokyo is big </s>",
        "<en> Rome </s> AD 12 the emperor ruled in Rome long </s>"])
    return titles, src, dst


@case("scripts.wiki.extract_comprable_from_titles")
def _(d):
    titles, src, dst = _wiki_docs(d)
    return [lambda o: [titles, src, dst, o / "s", o / "t", o / "first"]]


@case("scripts.wiki.extract_dense_alignments")
def _(d):
    return _dense(d)


@case("scripts.wiki.extract_first_sens_from_titles")
def _(d):
    titles, src, dst = _wiki_docs(d)
    return [lambda o: [titles, src, dst, o / "out"]]


@case("scripts.wiki.extract_trans_candidates_from_tltles_marshal")
def _(d):
    s = lines(d / "s", ["a b", "a b", "c", "a b", "d"])
    t = lines(d / "t", ["x", "y", "x", "z", "d"])
    return [lambda o: [s, t, o / "sens", o / "dict"],
            lambda o: [s, t, o / "sens2", o / "dict2", "2"]]


@case("scripts.wiki.extract_wiki_en_equivalent_from_html_files")
def _(d):
    pytest.importorskip("bs4")
    h = d / "html"
    h.mkdir()
    page = ('<div id="content"><h1> {t} </h1></div><nav id="p-lang"><ul>'
            '<li class="interlanguage-link interwiki-de"><a href="https://'
            'de.wikipedia.org/wiki/X">de</a></li>{en}</ul></nav>')
    en = ('<li class="interlanguage-link interwiki-en"><a href="https://'
          'en.wikipedia.org/wiki/{h}">en</a></li>')
    (h / "1.html").write_text(page.format(t="%D9%BE%D8%A7", en=en.format(
        h="New_York_%28city%29")))
    (h / "2.html").write_text(page.format(t="رم", en=""))
    (h / "3.html").write_text("<html>nothing</html>")
    (h / "4.html").write_text(page.format(t="برلین", en=en.format(
        h="Berlin")))
    return [lambda o: [h, o / "out"]]


@case("scripts.wiki.extract_wikipedia_language_links")
def _(d):
    docs = lines(d / "docs", ["<fa> پاریس شهر </s> x </s>", "<fa> fail me </s>",
                              "<fa> رم </s>", "<fa> last one </s>"])
    return [lambda o: ["--file", docs, "--lang", "fa", "--output",
                       o / "index", "--output_folder", o / "html"],
            lambda o: ["--file", docs, "--lang", "fa", "--output",
                       o / "index2", "--output_folder", o / "html2",
                       "--resume", "1", "--end", "3"]]


@case("scripts.wiki.flip_alignment_dir")
def _(d):
    p = lines(d / "p", ["a b ||| x y", "c d e ||| z"])
    a = lines(d / "a", ["0-0 1-1", "0-0 1-2-3 junk 2-0"])
    return [lambda o: [p, a, o / "p", o / "a"]]


@case("scripts.wiki.intersect_best_alignments")
def _(d):
    f = lines(d / "f", ["a b ||| x y\t0.5", "c ||| z\t0.25", "e ||| w\t0.9"])
    b = lines(d / "b", ["x y ||| a b\t0.5", "z ||| q\t0.7", "w ||| e\t0.1"])
    return [lambda o: [f, b, o / "out"]]


@case("scripts.wiki.intersect_from_scores_birdir")
def _(d):
    w8 = lambda tag, n=8: " ".join([tag] + [f"w{i}" for i in range(n - 1)])  # noqa: E731
    A, B = w8("<aa> alpha"), w8("<zz> beta")
    C, D = w8("<zz> gamma"), w8("<aa> delta")
    E, F = w8("<mm> eps"), w8("<nn> zeta")
    G, H = w8("<aa> eta"), w8("<bb> theta")
    inp = lines(d / "in", [f"{A}\t{B}\t0.9", f"{B}\t{A}\t0.8\textra\tfields",
                           f"{C}\t{D}\t0.7", f"{D}\t{C}\t0.95",
                           f"{E}\t{F}\t0.9", f"{G}\t{H}\t0.31",
                           f"{H}\t{G}\t0.3", f"short line\t{B}\t0.99",
                           "malformed", f"{A}\t{B}\tnan-ish"])
    return [lambda o: [inp, "0.3", "0.7", o / "out"]]


# ---------------- the runs ----------------

def _run_main(pkg, module, argv):
    mod = importlib.import_module(f"{pkg}.{module}")
    old = sys.argv
    sys.argv = [module.rsplit(".", 1)[-1]] + [str(a) for a in argv]
    out = io.StringIO()
    try:
        random.seed(0)
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
    return out.getvalue()


def _tree(root):
    got = {}
    for dirpath, dirs, names in os.walk(root):
        for name in dirs + names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                got[rel] = ("link", os.readlink(path))
            elif os.path.isfile(path):
                with open(path, "rb") as f:
                    got[rel] = f.read().replace(root.encode(), b"<OUT>")
    return got


@pytest.mark.parametrize("module", sorted(CASES))
def test_port_tool_writes_the_jax_bytes(module, tmp_path, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _wget_stub)

    def retrieve(url, path):
        if "fail" in url:
            raise OSError("no route")
        if "big" in url or "s.png" in url:
            return _image_stub(url, path)
        with open(path, "w") as f:
            f.write("<html>" + url + "</html>")
        return path, None

    def urlopen(*a, **k):
        raise OSError("no network in tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", retrieve)
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr("time.sleep", lambda s: None)
    inputs = tmp_path / "in"
    inputs.mkdir()
    runs = CASES[module](inputs)
    seen = {}
    for pkg in ("imagetranslate_tpu", "imagetranslate_tpu_torch"):
        out = tmp_path / pkg
        out.mkdir()
        stdout = [_run_main(pkg, module, argv(out)).replace(str(out), "<OUT>")
                  for argv in runs]
        seen[pkg] = (stdout, _tree(str(out)))
    assert seen["imagetranslate_tpu_torch"] == seen["imagetranslate_tpu"]
    assert seen["imagetranslate_tpu"][1] or any(seen["imagetranslate_tpu"][0])


def test_every_tool_has_a_case():
    tools = set()
    for top in ("comparable", "scripts", "mmid"):
        for dirpath, _, names in os.walk(os.path.join(REPO,
                                                      "imagetranslate_tpu",
                                                      top)):
            rel = os.path.relpath(dirpath, os.path.join(REPO,
                                                        "imagetranslate_tpu"))
            tools |= {rel.replace(os.sep, ".") + "." + n[:-3] for n in names
                      if n.endswith(".py") and n != "__init__.py"}
    tools -= {"comparable.sim_calculator", "mmid.mmid_sim"}
    assert sorted(tools) == sorted(CASES) and len(CASES) == 65


# JAX package files with no port counterpart: XLA's compilation cache,
# ahead-of-time compilation and the TPU runtime probes (PyTorch has no
# counterpart), and the JAX side of the weight bridge (the port's side is
# train/weights.py).
STAYS_OUT = {"utils/xla_cache.py", "utils/aot.py", "ops/runtime.py",
             "train/torch_import.py"}
RENAMED = {"ops/xent_pallas.py": "ops/xent.py"}


def test_every_jax_module_has_a_port_counterpart():
    jax_root = os.path.join(REPO, "imagetranslate_tpu")
    port_root = os.path.join(REPO, "imagetranslate_tpu_torch")
    missing = []
    for dirpath, dirs, names in os.walk(jax_root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for name in names:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), jax_root)
            rel = rel.replace(os.sep, "/")
            if rel in STAYS_OUT:
                continue
            if not os.path.isfile(os.path.join(port_root,
                                               RENAMED.get(rel, rel))):
                missing.append(rel)
    assert missing == []
    for rel in STAYS_OUT:
        assert os.path.isfile(os.path.join(jax_root, rel))
        assert not os.path.exists(os.path.join(port_root, rel))


_NO_JAX = textwrap.dedent("""
    import contextlib, importlib, importlib.abc, io, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "imagetranslate_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    d = sys.argv[1]

    def run(module, *argv):
        mod = importlib.import_module("imagetranslate_tpu_torch." + module)
        sys.argv = [module] + list(argv)
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()

    run("scripts.add_lang_id", d + "/s.txt", "en", d + "/s.tag")
    run("scripts.add_lang_id", d + "/t.txt", "fa", d + "/t.tag")
    run("comparable.sim_calculator", "--src", d + "/s.tag", "--dst",
        d + "/t.tag", "--src-embed", d + "/s.vec", "--dst-embed",
        d + "/t.vec", "--dict", d + "/dict.tsv", "--output", d + "/sc",
        "--device", "cpu")
    run("comparable.extract_best_comparable", "--src", d + "/s.tag",
        "--dst", d + "/t.tag", "--scores", d + "/sc", "--output",
        d + "/best", "--min", "-1000")
    with open(d + "/best") as r, open(d + "/pairs", "w") as w:
        w.write("".join(l.split("\\t")[0] + "\\n" for l in r))
    run("comparable.extract_parallel_using_dict", d + "/dict.tsv",
        d + "/pairs", d + "/pairs", d + "/para")
    run("scripts.eval_caption_bleu", d + "/caps.tsv", d + "/caps.tsv")
    run("scripts.wiki.extract_alignment_dict", d + "/pairs", d + "/align",
        d + "/adict")
    run("scripts.wiki.extract_dense_alignments", d + "/s.txt", d + "/t.txt",
        d + "/align", "0.1", d + "/dense")
    run("scripts.web_captions.filter_wiki_captions", d + "/caps.tsv",
        d + "/fcaps")
    run("mmid.extract_dict_common_w_fasttext", d + "/s.vec", d + "/t.vec",
        d + "/dict.tsv", d + "/common")
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
""")


def test_port_tools_run_without_jax(tmp_path):
    """The comparable-mining chain and tools that import a sibling, in a
    process where jax, flax and the JAX package cannot be imported."""
    pytest.importorskip("sacrebleu")
    words_s, words_t = ["gato", "perro", "casa", "7"], ["cat", "dog",
                                                         "house", "7"]
    for name, words in (("s.vec", words_s), ("t.vec", words_t)):
        lines(tmp_path / name, [w + " " + " ".join(str((i * 7 + j) % 5 - 2)
                                                   for j in range(4))
                                for i, w in enumerate(words)])
    lines(tmp_path / "dict.tsv", ["gato\tcat", "perro\tdog"])
    lines(tmp_path / "s.txt", ["gato perro casa", "casa 7", "perro gato"])
    lines(tmp_path / "t.txt", ["cat dog house", "house 7", "dog cat"])
    lines(tmp_path / "align", ["0-0 1-1", "0-0", "0-0 1-1"])
    lines(tmp_path / "caps.tsv", ["a.jpg\ta cat on a mat",
                                  "b.jpg\ta dog in the house"])
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO
           + os.pathsep + os.environ.get("PYTHONPATH", "")}
    subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                   check=True, cwd=REPO, env=env, timeout=300)
    assert len((tmp_path / "sc").read_text().splitlines()) == 3
    best = (tmp_path / "best").read_text().splitlines()
    assert len(best) == 3 and all(" ||| " in b for b in best)
    assert (tmp_path / "para").read_text().count("\n") >= 1
    assert (tmp_path / "common").read_text() == \
        "gato ||| cat\nperro ||| dog\n"
