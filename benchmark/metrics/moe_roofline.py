"""moe_roofline (%): the MoE bank's grouped expert products
(``kernels/moe.py``), the NLLB-MoE cell."""

import readers

read = readers.roofline("moe")
