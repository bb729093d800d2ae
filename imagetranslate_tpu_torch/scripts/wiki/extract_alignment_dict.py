"""Wiki variant of the mutual-best alignment dictionary (same contract as
scripts/extract_alignment_dict; reference scripts/wiki/extract_alignment_dict.py)."""
from imagetranslate_tpu_torch.scripts.extract_alignment_dict import main

if __name__ == "__main__":
    main()
