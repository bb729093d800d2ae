"""Caption BLEU via sacrebleu on path-keyed TSVs — alias of
eval_caption_sacre with the same argv (reference scripts/eval_caption_bleu.py
differs only in its BLEU backend)."""
from imagetranslate_tpu_torch.scripts.eval_caption_sacre import main

if __name__ == "__main__":
    main()
