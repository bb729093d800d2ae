"""k6_roofline (%): K6, the decode cross-attention over each source's K/V
read once for its beams, the decode cells."""

import readers

read = readers.roofline("k6")
