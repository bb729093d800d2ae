"""k2_roofline (%): K2, the vocabulary projection with top-k (both launches),
the decode cells."""

import readers

read = readers.roofline("k2")
