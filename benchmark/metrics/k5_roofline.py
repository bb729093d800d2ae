"""k5_roofline (%): K5, the fused label-smoothed cross-entropy (forward and
backward), packed training."""

import readers

read = readers.roofline("k5")
