"""moe_load.decode (%): routing imbalance, the largest expert segment of a
MoE bank's call over the mean segment (k T / E), summed over the calls of
the label pass (the program's counters ``moe.max_load`` and
``moe.choices``); 100 is an even load. It sets the grouped product's
longest segment. The NLLB-MoE cell."""


def read(r):
    m = r.get("moe")
    if not m or not m["choices"] or not m["max_load"]:
        return None
    return 100.0 * m["max_load"] * m["experts"] / m["choices"]
