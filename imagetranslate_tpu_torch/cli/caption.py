"""Image-folder captioning CLI (port of imagetranslate_tpu/cli/caption.py):
the same flags and the same output file, one ``path<TAB>caption`` line per
image (``.png`` entries are skipped), plus ``--device``.

Usage:
    python -m imagetranslate_tpu_torch.cli.caption --tok TOKDIR \
        --model CKPTDIR --input IMAGEDIR --output out.tsv --target en \
        [--device cuda]

The checkpoint is the JAX package's captioning layout (``params.msgpack``
holds ``{"params", "batch_stats"}``), so a captioner trained by that package
captions here. ``caption_batches`` is the decode loop alone: a caller with its
own batcher (dicts of ``paths``, uint8 ``images``, ``first_tokens`` and
``tgt_langs``, as ``data.images.ImageFolderBatcher`` yields them) drives it
directly, and with ``box_features``/``object_labels`` in a batch it runs the
grid + object decode.

``--obj --fcnn DETECTOR.pth`` adds the object stream: a torchvision
``fasterrcnn_resnet50_fpn`` state_dict (``build_object_extractor``) detects
objects in each image at 800 pixels (staged as uint8 by the prefetch thread,
the paths padded to the grid batch's rows), and the grid + object decode
(``beam_search_dual``) captions from both.
"""

from __future__ import annotations

import argparse
import sys

import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("caption")
    p.add_argument("--input", dest="input_path", required=True,
                   help="folder of images")
    p.add_argument("--target", dest="target_lang", required=True)
    p.add_argument("--output", dest="output_path", required=True)
    # The JAX CLI's default.
    p.add_argument("--batch", dest="batch", type=int, default=192)
    p.add_argument("--tok", dest="tokenizer_path", required=True)
    p.add_argument("--model", dest="model_path", required=True)
    p.add_argument("--beam", dest="beam_width", type=int, default=4)
    p.add_argument("--max_len", type=int, default=256)
    p.add_argument("--len-penalty", dest="len_penalty_ratio", type=float,
                   default=0.8)
    p.add_argument("--obj", dest="use_obj", action="store_true",
                   help="object stream: Faster R-CNN box features blended "
                        "into the decode")
    p.add_argument("--fcnn", dest="detector_path", default=None,
                   help="torchvision fasterrcnn_resnet50_fpn state_dict "
                        "(.pth); required with --obj")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (cuda, cuda:N or cpu)")
    return p


def load_captioner(path: str, device):
    """A captioning checkpoint -> ``ImageSeq2Seq`` on ``device`` in
    inference mode, its weights stored in the compute dtype."""
    from imagetranslate_tpu_torch.models.captioning import ImageSeq2Seq
    from imagetranslate_tpu_torch.train.checkpoint import (
        load_config,
        load_variables,
    )
    from imagetranslate_tpu_torch.train.weights import CAPTION

    cfg = load_config(path)
    variables = load_variables(path)
    kw = {}
    if cfg.use_obj:
        kw["object_feat_dim"] = variables["params"]["object_feat_fc"][
            "kernel"].shape[0]
    model = ImageSeq2Seq(cfg, device=torch.device(device), **kw)
    model.load_state_dict(CAPTION.state_dict_from_flax(variables, cfg),
                          strict=True)
    return model.eval()


DET_SIZE = 800          # the detector's input: short side 800, centre crop
DET_CHUNK = 8           # images a detector forward, to bound its memory


def build_object_extractor(detector_path: str, device="cuda"):
    """Load a torchvision ``fasterrcnn_resnet50_fpn`` state_dict (``.pth``)
    and return images ([B, 800, 800, 3] uint8, any device) ->
    (box_features [B, 36, 1031] float32, labels [B, 36] int32) on
    ``device``. The detector runs ``DET_CHUNK`` images at a time: its
    RoIAlign and NMS hold a few hundred MB an image."""
    from imagetranslate_tpu_torch.models.detector import (
        FasterRCNN,
        detection_to_object_inputs,
    )
    from imagetranslate_tpu_torch.train.weights import load_torchvision_frcnn

    device = torch.device(device)
    detector = FasterRCNN(device=device)
    detector.load_state_dict(load_torchvision_frcnn(
        torch.load(detector_path, map_location="cpu")))
    detector.eval()

    @torch.no_grad()
    def extract(images):
        images = torch.as_tensor(images).to(device)
        outs = [detection_to_object_inputs(
            detector(images[i:i + DET_CHUNK]), image_size=DET_SIZE)
            for i in range(0, images.shape[0], DET_CHUNK)]
        return (torch.cat([f for f, _ in outs]),
                torch.cat([lab for _, lab in outs]))

    return extract


def build_model(options):
    from imagetranslate_tpu_torch.text.processor import TextProcessor

    tp = TextProcessor(options.tokenizer_path)
    model = load_captioner(options.model_path, options.device)
    return model, model.cfg, tp


def caption_batches(model, tp, batches, writer, *, beam_width: int = 4,
                    max_len: int = 256, len_penalty_ratio: float = 0.8,
                    extract=None) -> int:
    """Caption every batch of ``batches`` and write ``path<TAB>caption``
    lines to ``writer``; returns the number of images. The staging of batch
    N+1 (its decode on the host and its copy to the device) overlaps the beam
    search of batch N. With ``extract`` (``build_object_extractor``) the
    staging also decodes each batch's files at 800 pixels for the detector,
    and the detections feed the object stream."""
    from imagetranslate_tpu_torch.data.prefetch import (
        PrefetchIterator,
        default_image_pool,
    )
    from imagetranslate_tpu_torch.decoding.beam import (
        beam_search,
        beam_search_dual,
        trim_outputs,
    )

    cfg = model.cfg
    device = next(model.parameters()).device
    L = min(max_len, cfg.max_position_embeddings)
    common = dict(beam_width=beam_width, max_len=L,
                  len_penalty_ratio=len_penalty_ratio,
                  pad_id=tp.pad_token_id(), eos_id=tp.sep_token_id())

    def stage(batch):
        staged = dict(batch)
        for key in ("images", "first_tokens", "tgt_langs", "box_features",
                    "object_labels"):
            if key in batch:
                staged[key] = torch.as_tensor(batch[key]).to(device)
        if extract is not None:
            # The detector's rows match the grid's, tail padding included.
            rows = staged["images"].shape[0]
            paths = list(batch["paths"])
            paths += paths[:1] * (rows - len(paths))
            staged["det_images"] = torch.as_tensor(default_image_pool().decode(
                paths, size=DET_SIZE, resize_min=DET_SIZE, raw=True)).to(
                    device)
        return staged

    n = 0
    with torch.no_grad(), PrefetchIterator(batches, stage, depth=2) as staged:
        for batch in staged:
            if "det_images" in batch:
                batch["box_features"], batch["object_labels"] = extract(
                    batch["det_images"])
            grid = model.encode_images(batch["images"])
            img_mask = torch.ones(grid.shape[:2], dtype=torch.bool,
                                  device=device)
            if "box_features" in batch:
                obj_states, obj_keep = model.encode_objects(
                    batch["box_features"], batch["object_labels"])
                best, lengths = beam_search_dual(
                    model, grid, img_mask, obj_states, batch["first_tokens"],
                    batch["tgt_langs"], None, grid_mask=obj_keep,
                    init_method=type(model).init_obj_dual_cache,
                    step_method=type(model).decode_step_obj_dual, **common)
            else:
                best, lengths = beam_search(
                    model, grid, img_mask, batch["first_tokens"],
                    batch["tgt_langs"], None, **common)
            outs = trim_outputs(best, lengths, remove_first_token=True)
            for path, o in zip(batch["paths"], outs):
                writer.write(path + "\t" + tp.decode(o) + "\n")
            n += len(batch["paths"])
            print(f"Captioned {n} images", end="\r", file=sys.stderr)
    print(f"\nCaptioned {n} images", file=sys.stderr)
    return n


def main(argv=None):
    options = get_parser().parse_args(argv)
    if options.use_obj and options.detector_path is None:
        raise SystemExit("--obj needs --fcnn <state_dict.pth>")

    from imagetranslate_tpu_torch.data.images import ImageFolderBatcher

    model, cfg, tp = build_model(options)
    extract = None
    if options.use_obj:
        extract = build_object_extractor(options.detector_path,
                                         options.device)
    target_lang_tok = f"<{options.target_lang}>"
    batcher = ImageFolderBatcher(options.input_path, options.batch,
                                 tp.languages[target_lang_tok],
                                 tp.token_id(target_lang_tok),
                                 img_size=cfg.img_size)
    with open(options.output_path, "w") as writer:
        caption_batches(model, tp, batcher, writer,
                        beam_width=options.beam_width,
                        max_len=options.max_len,
                        len_penalty_ratio=options.len_penalty_ratio,
                        extract=extract)


if __name__ == "__main__":
    main()
