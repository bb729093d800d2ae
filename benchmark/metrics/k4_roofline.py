"""k4_roofline (%): K4, the beam decode attention over the bf16 cache, the
decode cells."""

import readers

read = readers.roofline("k4")
