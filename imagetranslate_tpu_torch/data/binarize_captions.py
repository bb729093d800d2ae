"""Caption binarizers (port of imagetranslate_tpu/data/binarize_captions.py:
``write_from_list``, ``write_from_coco`` and ``write_from_wiki_json``).

All three write the marshal tuple that ``data.images.CaptionBatcher`` reads:

    (unique_images {image_id: path}, [(image_id, caption_ids), ...])

with the captions sorted by length (stable) and captions longer than
``max_len`` tokens dropped; image ids number the distinct paths in the order
they are first seen. The file is byte for byte the JAX package's. The packed
record format (``packed=True``) is not ported (ROADMAP module 15).
"""

from __future__ import annotations

import json
import marshal
import os
from typing import Dict, Iterable, List, Optional, Tuple

from imagetranslate_tpu_torch.text.processor import TextProcessor

PACKED_REFUSAL = ("packed=True: the packed record format is not ported yet "
                  "(ROADMAP module 15)")


def _finalize(tp: TextProcessor, output_file: str,
              captions: Iterable[Tuple[str, str]], max_len: int,
              sample_size: int = -1, path_fixer=None, packed: bool = False,
              path_checker=None) -> int:
    """Tokenize, number the image paths, sort by length, dump; returns the
    number of captions written.

    ``path_checker(path) -> bool`` runs the first time a path is seen; a
    path that fails drops its caption and stays unnumbered, so a later
    caption of the same path probes it again."""
    if packed:
        raise NotImplementedError(PACKED_REFUSAL)
    skipped = 0
    skipped_imgs = 0
    image_path_dict: Dict[str, int] = {}
    unique_images: Dict[int, str] = {}
    tok_captions: Dict[int, List[int]] = {}
    image_ids: Dict[int, int] = {}
    for ci, (path, caption) in enumerate(captions):
        tok_sen = tp.tokenize_one_sentence(caption)
        if len(tok_sen) > max_len:
            skipped += 1
            continue
        if path_fixer is not None:
            path = path_fixer(path)
        if path not in image_path_dict:
            if path_checker is not None and not path_checker(path):
                skipped_imgs += 1
                continue
            image_id = len(unique_images)
            unique_images[image_id] = path
            image_path_dict[path] = image_id
        else:
            image_id = image_path_dict[path]
        caption_id = len(tok_captions)
        tok_captions[caption_id] = tok_sen
        image_ids[caption_id] = image_id
        if sample_size > 0 and ci + 1 >= sample_size:
            break

    print(f"Skipped long sentences: {skipped}")
    if skipped_imgs:
        print(f"Skipped unreadable images: {skipped_imgs}")
    by_len = sorted(tok_captions.items(), key=lambda kv: len(kv[1]))
    caption_sorted = [(image_ids[cid], ids) for cid, ids in by_len]
    with open(output_file, "wb") as wfp:
        marshal.dump((unique_images, caption_sorted), wfp)
    print(f"Dumped {len(caption_sorted)} captions from "
          f"{len(unique_images)} unique images")
    return len(caption_sorted)


def _sniff_extension(path: str) -> str:
    """An extension-less path takes the first of .jpg, .jpeg, .JPG, .png,
    .PNG under which a file exists."""
    if "." in path:
        return path
    for ext in (".jpg", ".jpeg", ".JPG", ".png", ".PNG"):
        if os.path.exists(path + ext):
            return path + ext
    return path


def write_from_list(tp: TextProcessor, output_file: str, input_file: str,
                    max_len: int = 256, sample_size: int = -1,
                    lang: Optional[str] = None, packed: bool = False) -> int:
    """A TSV of "path<TAB>caption" lines. With ``lang`` a caption that does
    not start with "<lang>" becomes "<lang> caption </s>"; a line without
    exactly one tab is printed and skipped; ``sample_size`` counts the
    lines parsed."""
    if packed:
        raise NotImplementedError(PACKED_REFUSAL)
    lang_tok = f"<{lang}>" if lang is not None else None

    def gen():
        with open(input_file) as r:
            for line in r:
                try:
                    path, caption = line.strip().split("\t")
                except ValueError:
                    print(line.strip())
                    continue
                if lang_tok is not None and not caption.startswith(lang_tok):
                    caption = " ".join([lang_tok, caption, "</s>"])
                yield path, caption

    return _finalize(tp, output_file, gen(), max_len, sample_size,
                     path_fixer=_sniff_extension)


def write_from_coco(tp: TextProcessor, output_file: str, input_file: str,
                    max_len: int = 256, sample_size: int = -1,
                    packed: bool = False) -> int:
    """A COCO annotation JSON: each caption "<en> caption </s>" of the image
    file named by its 12-digit zero-padded id + ".jpg"."""
    if packed:
        raise NotImplementedError(PACKED_REFUSAL)
    with open(input_file) as r:
        obj = json.load(r)

    def id2path(img_id: str) -> str:
        return "0" * (12 - len(img_id)) + img_id + ".jpg"

    def gen():
        for ann in obj["annotations"]:
            yield (id2path(str(ann["image_id"])),
                   " ".join(["<en>", ann["caption"], "</s>"]))

    return _finalize(tp, output_file, gen(), max_len, sample_size)


def write_from_wiki_json(tp: TextProcessor, output_file: str, input_file: str,
                         max_len: int = 256, only_captions: bool = False,
                         choose_relevant: bool = True, packed: bool = False,
                         root_img_dir: Optional[str] = None,
                         skip_check: bool = False,
                         ref_file: Optional[str] = None) -> int:
    """A wiki-document JSON [{content, images: [{img_path, caption}]}] with
    three ways to pick an image's captions: its caption only
    (``only_captions``); the document's sentences that share the most words
    with the caption (``choose_relevant``, the default; the caption itself
    when none does); or the caption and every sentence of at least seven
    tokens.

    ``ref_file``: a second such JSON; a document that shares no img_path
    with it is dropped. Unless ``skip_check``, each image is opened and
    converted to RGB the first time it is seen (under ``root_img_dir``), and
    one that fails drops its captions."""
    if packed:
        raise NotImplementedError(PACKED_REFUSAL)
    with open(input_file) as fp:
        doc_dicts = json.load(fp)

    ref_images = None
    if ref_file is not None:
        with open(ref_file) as fp:
            ref_images = {im["img_path"] for v in json.load(fp)
                          for im in v["images"]}

    def doc_sentences(v):
        spl = v["content"].strip().split(" ")
        lang_id = spl[0] + " "
        content = " ".join(spl[1:])
        return [lang_id + s.strip() + " </s>" for s in content.split("</s>")]

    def gen():
        for v in doc_dicts:
            if ref_images is not None and not any(
                    im["img_path"] in ref_images for im in v["images"]):
                continue
            if only_captions:
                for img in v["images"]:
                    yield img["img_path"], img["caption"]
            elif choose_relevant:
                sens = doc_sentences(v)
                sen_words = [set(s.split()[1:-1]) for s in sens]
                for img in v["images"]:
                    caption_words = set(
                        img["caption"].strip().split(" ")[1:-1])
                    counts = [len(s & caption_words) for s in sen_words]
                    least = max(2, max(counts, default=0) - 2)
                    chosen = [sens[i] for i, c in enumerate(counts)
                              if c > least]
                    for s in chosen or [img["caption"]]:
                        yield img["img_path"], s
            else:
                sens = [s for s in doc_sentences(v)
                        if len(s.strip().split(" ")) >= 7]  # lang + 5 + </s>
                for img in v["images"]:
                    yield img["img_path"], img["caption"]
                    for s in sens:
                        yield img["img_path"], s

    checker = None
    if not skip_check:
        from PIL import Image

        def checker(path):
            try:
                with Image.open(os.path.join(root_img_dir or "", path)) as im:
                    im.convert("RGB")
                return True
            except Exception:
                return False

    return _finalize(tp, output_file, gen(), max_len, path_checker=checker)
