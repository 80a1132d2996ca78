"""``ttft_p95_ms``'s reading (``metrics/ttft_p95_ms.py``) in the cells
whose closed loop keeps every slot full. There the tail is set by how many
prompts one admission call takes at once, which the seed's order of the
sizes decides more than the program does, so it stands per layer and
``output_tok_s`` is the cells' end-to-end rate."""

import os

from pbench import spec

LAYER = "serving loop"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "output_tok_s"

read = spec.metric_reader(
    "ttft_p95_ms", os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))).read
