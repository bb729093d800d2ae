"""Wiki variant of the dense-alignment filter (same contract as
scripts/extract_dense_alignments; reference scripts/wiki/extract_dense_alignments.py)."""
from imagetranslate_tpu_torch.scripts.extract_dense_alignments import main

if __name__ == "__main__":
    main()
