"""Mistral-7B, the LLaMA family's dense decoder (GQA, rope, RMSNorm, SwiGLU,
the sliding window).

The port's model is ``models/llama.py``, built by ``pbench/port.py``
from ``pbench/weights.py``'s ``layer`` and ``globals_``; the plain
reference is ``reference/model.py``; the work is ``pbench/work.py``'s
dense count.
"""

from pbench import port, work
from reference import model as ref

build_model = port.build_model
logits = ref.logits
Work = work.Work
