"""SqueezeLLM Dense-and-Sparse inference in PyTorch and CUDA for Hopper.

The port of the JAX package ``squeezellm_tpu`` (which stays the
reference) to one NVIDIA H100. Every Pallas kernel on the ported path is a
CUDA kernel written for ``sm_90a``; everything else is plain PyTorch. The
port imports neither JAX nor the JAX package.

Layer map:
  formats       packed-weight layout (own copy of the shared format)
  checkpoint    reads the shared checkpoint format
  carry         JAX parameter tree -> the port's model
  ops           K1 lut_matmul, K2 decode_attn, K3 flash_attn (each a CUDA
                kernel with its plain PyTorch version), plain_ops,
                quant_linear
  models        LLaMA-family decoder, decode-time fusion, registry
  engine        prefill + greedy decode, decode benchmark
  synthetic     random flagship models made on the device
  _build        nvcc build of csrc/*.cu at first use, ctypes binding

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
a kernel wrapper takes its plain version only for CPU tensors.
"""

__version__ = "0.1.0"
