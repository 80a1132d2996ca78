"""OPT-6.7B's dense decoder (MHA, learned positions, pre-LayerNorm, biases,
the head tied to the embedding).

The port's model is ``models/opt.py``, built by ``pbench/port.py``
from ``pbench/weights.py``'s ``layer`` and ``globals_``; the plain
reference is ``reference/model.py``; the work is ``pbench/work.py``'s
dense count.
"""

from pbench import port, work
from reference import model as ref

build_model = port.build_model
logits = ref.logits
Work = work.Work
