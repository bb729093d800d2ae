"""Recursive variant of caption-candidate extraction over nested HTML dirs
(same contract; reference scripts/web_captions/extract_caption_subfolders.py)."""
from imagetranslate_tpu_torch.scripts.web_captions.extract_caption_candidates_from_html_files import main

if __name__ == "__main__":
    main()
