"""The plain reference: the models' mathematics in plain PyTorch, fp32 with
TF32 off, written from the published architecture (HF-2.9 BertModel
post-LayerNorm blocks, the reference repository's ResNet grid) and imported
from nothing of the program under test."""
