"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit): the rates the roofline and utilisation
metrics divide by. A result line of a traced run carries the card's name
and power limit beside them (``device.card``)."""

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}
