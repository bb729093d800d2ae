"""k1_roofline (%): K1, the fused dropout attention (forward and backward),
both training cells."""

import readers

read = readers.roofline("k1")
