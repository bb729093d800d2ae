"""Corpus-mining & utility CLI toolbox (reference: src/scripts, ~2.9k LoC of
offline, host-only helpers — SURVEY §2.10), the port's own copy of
imagetranslate_tpu/scripts: the same argv and the same output bytes. Run as
`python -m imagetranslate_tpu_torch.scripts.<name> ...`."""
