"""The port's ``comparable.sim_calculator`` on the CPU against the JAX
tool's ``sentence_sim`` and CLI, on generated word vectors.

One case per trap of the batched scoring: row 0 (the raw 1e-4 vector) for
OOV src words, a pair whose dst words are all OOV, OOV dst words that still
match by dictionary, identity and number, the boost of 0 that clamps
negative cosines before the -100 poison of an unmatched number, the number
flags (dictionary and identity matches, Persian and Devanagari digits
without --convert), and --convert; then a pair scored alone against the
same pair inside batches of mixed lengths, and both CLIs over the same
files. Scores within rtol and atol 1e-6: the port sums each pair's terms in
fp64 and rounds to fp32, the JAX tool sums them in fp32, and the two fp32
products block their sums in their own ways.
"""

import io
import contextlib
import os

import numpy as np
import pytest
import torch

from imagetranslate_tpu.comparable import sim_calculator as jsc
from imagetranslate_tpu_torch.comparable import sim_calculator as tsc

TOL = dict(rtol=1e-6, atol=1e-6)
DIM = 24

SRC_WORDS = ["gato", "perro", "casa", "rojo", "azul", "anti", "۱۲", "42",
             "Mayus", "१२"]
DST_WORDS = ["cat", "dog", "house", "red", "blue", "pro", "12", "42", "13",
             "mayus"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Vector files (a header line, a short line and a wrong-width line
    among them: read_embed skips all three) and a dictionary."""
    d = tmp_path_factory.mktemp("sim")
    rng = np.random.RandomState(0)
    vecs = {}

    def write(path, words):
        with open(path, "w") as w:
            w.write(f"{len(words)} {DIM}\n")
            w.write("short 0.5\n")
            for i, wd in enumerate(words):
                v = rng.randn(DIM) * (1 + i)
                if wd == "pro":  # the exact opposite of "anti"
                    v = -vecs["anti"] * 3.0
                vecs[wd] = v
                w.write(wd + " " + " ".join(f"{x:.6f}" for x in v) + "\n")
                if i == 2:
                    w.write("wide " + " ".join(["0.1"] * (DIM + 1)) + "\n")

    write(d / "s.vec", SRC_WORDS)
    write(d / "d.vec", DST_WORDS)
    (d / "dict.tsv").write_text(
        "gato\tcat\nperro\tdog\nperro\tperrito\nCASA\tHogar\n"
        "bad line\n42\tforty-two\n۱۲\tdoce\n")
    return d


@pytest.fixture(scope="module")
def tables(files):
    src = jsc.read_embed(files / "s.vec")
    dst = jsc.read_embed(files / "d.vec")
    return src, dst, jsc.read_dict(str(files / "dict.tsv"))


def jax_scores(tables, pairs, convert):
    (se, si), (de, di), d = tables
    return np.array([jsc.sentence_sim(s.split(" "), t.split(" "), se, si,
                                      de, di, d, convert)
                     for s, t in pairs])


def port_scores(tables, pairs, convert):
    (se, si), (de, di), d = tables
    scorer = tsc.SimScorer(se, si, de, di, d, convert, device="cpu")
    return scorer.score([s.split(" ") for s, _ in pairs],
                        [t.split(" ") for _, t in pairs])


def test_read_embed_equals_jax(files):
    for name in ("s.vec", "d.vec"):
        ja, ji = jsc.read_embed(files / name)
        ta, ti = tsc.read_embed(files / name)
        assert ti == ji and "short" not in ti and "wide" not in ti
        np.testing.assert_array_equal(ta, ja)
        assert np.all(ta[0] == np.float32(1e-4))          # never normalized
        np.testing.assert_allclose(np.linalg.norm(ta[1:], axis=-1), 1.0,
                                   atol=1e-3)


TRAPS = {
    # 1: an OOV src word reads row 0, the raw 1e-4 vector.
    "oov_src_reads_row_0": [("zzz gato", "cat dog"), ("qqq", "red blue"),
                            ("zzz yyy", "house")],
    # 2: a pair whose dst words are all OOV scores against row 0 alone.
    "all_oov_dst_scores_row_0": [("gato rojo", "xxx www"), ("zzz", "vvv"),
                                 ("casa", "")],
    # 3: OOV dst words drop out of the cosine but match by dictionary,
    # identity and number.
    "oov_dst_still_matches": [("perro azul", "perrito xxx red"),
                              ("42 casa", "42x forty-two house"),
                              ("zorro 77", "zorro 77 blue"),
                              ("77 gato", "78 cat")],
    # 4: max(cos, 0) clamps a negative cosine to 0; then an unmatched
    # number's -100.
    "boost_clamps_then_poison": [("anti", "pro"), ("anti rojo", "pro red"),
                                 ("anti 5", "pro 6"), ("anti 5", "pro 5")],
    # 5: a number's flag: dictionary or identity match (the break), or an
    # equal dst number string; Persian and Devanagari digits are digits
    # for str.isdigit even without --convert.
    "number_flags": [("42 gato", "forty-two cat"), ("42", "42"),
                     ("۱۲ gato", "doce cat"), ("۱۲ gato", "12 cat"),
                     ("१२ perro", "12 dog"), ("3.5 casa", "3.5 house"),
                     ("3.5.1 casa", "house"), ("12 ۱۲", "12 ۱۲"),
                     ("mayus Mayus", "MAYUS")],
}


@pytest.mark.parametrize("name", sorted(TRAPS))
def test_trap_equals_jax(tables, name):
    pairs = TRAPS[name]
    want = jax_scores(tables, pairs, False)
    got = port_scores(tables, pairs, False)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    if name == "boost_clamps_then_poison":
        assert want[0] == 0.0 and want[2] < -99 and want[3] > -1
    if name == "number_flags":
        assert want[3] < -98 and want[4] < -98       # no --convert
    if name == "all_oov_dst_scores_row_0":
        assert np.all(np.abs(want) < 1e-3)


def test_convert_equals_jax(tables):
    pairs = [p for v in TRAPS.values() for p in v]
    want = jax_scores(tables, pairs, True)
    np.testing.assert_allclose(port_scores(tables, pairs, True), want,
                               **TOL)
    i = pairs.index(("۱۲ gato", "12 cat"))
    assert want[i] > 0 and jax_scores(tables, [pairs[i]], False)[0] < -98


def test_a_pair_scores_the_same_alone_and_in_any_batch(tables, monkeypatch):
    """Padding leaks nothing: a pair alone, among 59 others of 1-11 and
    1-14 words, and among another half of them, scores the same up to the
    rounding of the fp32 product, whose blocking follows the batch's padded
    shape (a row-0 leak would move a score by ~1e-4); and the same pairs
    under budgets that split them into many batches."""
    rng = np.random.RandomState(1)
    words_s = SRC_WORDS + ["zzz", "77", "casa"]
    words_d = DST_WORDS + ["www", "77", "forty-two"]
    pairs = [(" ".join(rng.choice(words_s, rng.randint(1, 12))),
              " ".join(rng.choice(words_d, rng.randint(1, 15))))
             for _ in range(60)]
    (se, si), (de, di), d = tables
    scorer = tsc.SimScorer(se, si, de, di, d, False, device="cpu")
    split = [(s.split(" "), t.split(" ")) for s, t in pairs]
    together = scorer.score([s for s, _ in split], [t for _, t in split])
    alone = np.array([scorer.score([s], [t])[0] for s, t in split])
    np.testing.assert_allclose(together, alone, **TOL)
    halves = np.concatenate([scorer.score([s for s, _ in split[i::2]],
                                          [t for _, t in split[i::2]])
                             for i in (1, 0)])
    order = np.concatenate([np.arange(60)[1::2], np.arange(60)[0::2]])
    np.testing.assert_allclose(halves, together[order], **TOL)
    monkeypatch.setattr(tsc, "WORD_BUDGET", 48)
    monkeypatch.setattr(tsc, "CELL_BUDGET", 300)
    calls = []
    real = scorer._score_batch
    monkeypatch.setattr(scorer, "_score_batch",
                        lambda s, t: calls.append(len(s)) or real(s, t))
    small = scorer.score([s for s, _ in split], [t for _, t in split])
    assert len(calls) > 6 and sum(calls) == 60
    np.testing.assert_allclose(small, together, **TOL)
    np.testing.assert_allclose(together, jax_scores(tables, pairs, False),
                               **TOL)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("convert", [False, True])
def test_both_clis_write_the_same_scores(files, tmp_path, convert,
                                         monkeypatch):
    pairs = [p for v in TRAPS.values() for p in v]
    (tmp_path / "s.txt").write_text(
        "\n".join(s.upper() if i % 3 == 0 else s
                  for i, (s, _) in enumerate(pairs)) + "\n")
    (tmp_path / "d.txt").write_text("\n".join(t for _, t in pairs) + "\n")
    base = ["--src", str(tmp_path / "s.txt"), "--dst",
            str(tmp_path / "d.txt"), "--src-embed", str(files / "s.vec"),
            "--dst-embed", str(files / "d.vec"), "--dict",
            str(files / "dict.tsv")] + (["--convert"] if convert else [])
    monkeypatch.setattr("sys.argv", ["sim_calculator"] + base
                        + ["--output", str(tmp_path / "jax.sc")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jsc.main()
    assert _run(tsc.main, base + ["--output", str(tmp_path / "port.sc"),
                                  "--device", "cpu"]) == out.getvalue()
    want = [float(x) for x in (tmp_path / "jax.sc").read_text().split()]
    got = [float(x) for x in (tmp_path / "port.sc").read_text().split()]
    assert len(got) == len(want) == len(pairs)
    np.testing.assert_allclose(got, want, **TOL)


def test_cuda_without_a_card_raises(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "s.txt").write_text("gato\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsc.main(["--src", str(tmp_path / "s.txt"), "--dst",
                  str(tmp_path / "s.txt"), "--src-embed",
                  str(files / "s.vec"), "--dst-embed", str(files / "d.vec"),
                  "--output", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")
