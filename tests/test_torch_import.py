"""The port stands alone: importing every module of squeezellm_tpu_torch
(eval, data, cli, serving, sampling, models.opt, ops.kv_quant and
ops.paged_attn among them) and running a CPU forward, greedy generation,
the decode benchmark, an int8-cache OPT request, a perplexity through the
dequantize-then-matmul route, a paged serving run (int8 pool, speculation,
then sampling), the command line, the offline quantization (Fisher
gradients, a structured and a free `quantize_model`, outliers from an IQR
config, the checkpoint writer, the HF loader) and the structured and
transposed decode tables (K10, K11 and K12's plain versions) loads neither
JAX nor the JAX package (matched as the exact module `squeezellm_tpu` or
its submodules, not as a prefix of the port's name)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, json, pkgutil, sys
import numpy as np
import squeezellm_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from squeezellm_tpu_torch import engine, synthetic
from squeezellm_tpu_torch.models import fuse, llama
cfg = llama.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                        n_layers=1, n_heads=2, n_kv_heads=1, max_seq=32)
model = synthetic.quantized_llama(cfg, 3, sparsity=0.02, topx=2, device="cpu")
eng = engine.Engine(fuse.fuse_for_decode(model))
out = eng.generate(np.array([[1, 2, 3]]), 4)
stats = eng.benchmark(np.arange(8)[None], max_seq=32, check=True)
logits = model.forward(__import__("torch").tensor([[1, 2, 3]]))
from squeezellm_tpu_torch import data
from squeezellm_tpu_torch import eval as eval_mod
from squeezellm_tpu_torch.models import opt
from squeezellm_tpu_torch.ops import kv_quant, quant_linear
ocfg = opt.OPTConfig(vocab_size=64, hidden_size=64, ffn_dim=96, n_layers=1,
                     n_heads=2, max_seq=32)
omodel = synthetic.quantized_opt(ocfg, 4, sparsity=0.02, topx=2, device="cpu")
oout = engine.Engine(omodel, cache_dtype="int8").generate(
    np.array([[1, 2, 3]]), 4)
quant_linear.BIG_BATCH = 16
ppl = eval_mod.perplexity(omodel, data.synthetic_tokens(64, 48), seqlen=16,
                          group=2)
from squeezellm_tpu_torch import sampling, serving
from squeezellm_tpu_torch.ops import paged_attn
served = serving.PagedContinuousBatchEngine(
    model, slots=2, n_pages=12, page_size=8, cache_dtype="int8",
    speculative=(2, 2)).run([[1, 2, 3], [4, 5, 4, 5, 4]], max_new_tokens=3)
sampled = serving.PagedContinuousBatchEngine(
    omodel, slots=2, n_pages=12, page_size=8,
    cache_dtype=__import__("torch").float32).run(
        [[1, 2, 3]], max_new_tokens=3, window=2,
        sampling=sampling.SamplingParams(temperature=0.8, top_k=8))
import os, tempfile, torch
from squeezellm_tpu_torch import checkpoint
from squeezellm_tpu_torch.quantize import (gradients, kmeans, outlier_config,
                                           outliers, pipeline)
from squeezellm_tpu_torch.utils import hf
tree = {"embed": torch.randn(64, 64) * 0.02, "final_norm": torch.ones(64),
        "lm_head": {"w": torch.randn(64, 64) * 0.02},
        "layers": [dict({n: {"w": torch.randn(o, i) * 0.1}
                         for n, (o, i) in cfg.linear_shapes().items()},
                        input_norm=torch.ones(64), post_norm=torch.ones(64))]}
grads = gradients.compute_fisher("llama", cfg, tree, np.arange(16)[None],
                                 device="cpu")
oc = outlier_config.make_outlier_config(
    [{n: tree["layers"][0][n]["w"] for n in cfg.linear_shapes()}], 1.8)
specs, qp = pipeline.quantize_model(
    "llama", cfg, tree, 4, gradients_per_layer=grads, sensitivity=0.45,
    outlier_config=oc["outlier_config"], quantize_lm_head=True,
    structured=True, device="cpu")
pipeline.quantize_model("llama", cfg, tree, 3, device="cpu")
ckpt = tempfile.mkdtemp()
checkpoint.save_quantized(ckpt, "llama", cfg, specs, qp)
qmodel = fuse.fuse_for_decode(checkpoint.load_quantized(ckpt, "cpu")[1])
struct = engine.Engine(qmodel).generate(np.array([[1, 2, 3]]), 4)
fuse.attach_decode_luts(qmodel, transposed=True)
transposed = engine.Engine(qmodel).generate(np.array([[1, 2, 3]]), 4)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "squeezellm_tpu"
             or m.startswith("squeezellm_tpu."))
print(json.dumps({"bad": bad, "shape": list(out.shape),
                  "logits": list(logits.shape), "opt": list(oout.shape),
                  "served": [len(served[0]), len(served[1]), len(sampled[0])],
                  "quantized": [list(struct.shape), list(transposed.shape)],
                  "finite": bool(np.isfinite(stats["check_ppl"])
                                 and np.isfinite(ppl))}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["shape"] == [1, 7] and got["logits"] == [1, 3, 64]
    assert got["opt"] == [1, 7]
    assert got["served"] == [3, 3, 3]
    assert got["quantized"] == [[1, 7], [1, 7]]
    assert got["finite"]
