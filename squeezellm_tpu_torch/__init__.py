"""SqueezeLLM Dense-and-Sparse inference in PyTorch and CUDA for Hopper.

The port of the JAX package ``squeezellm_tpu`` (which stays the
reference) to one NVIDIA H100. Every Pallas kernel on the ported path is a
CUDA kernel written for ``sm_90a``; everything else is plain PyTorch. The
port imports neither JAX nor the JAX package.

Layer map:
  formats       packed-weight layout, packing and unpacking (own copy of
                the shared format)
  data          eval and calibration token sources (own copy)
  checkpoint    writes and reads the shared checkpoint format
  carry         JAX parameter tree -> the port's model
  ops           K1 lut_matmul and K10 lut_matmul_struct (structured
                codebooks), K11 lut_matmul_t (transposed 4-bit GEMV), K12
                spmv (CSR sparse sum), K2/K5 decode_attn (bf16 and int8
                cache), K3 flash_attn, K4 dequant_dense, K6-K9 paged_attn
                (decode and verify window through a page table, bf16 and
                int8 pool; each a CUDA kernel with its plain PyTorch
                version), kv_quant, plain_ops, quant_linear
  quantize      offline pipeline on the card: Fisher gradients, k-means
                (free and structured), outliers, quantize_model
  utils/hf      dense HF checkpoints (.bin, .safetensors)
  models        LLaMA-family and OPT decoders, decode-time fusion, registry
  engine        prefill + greedy decode, decode benchmark
  serving       paged continuous batching: page pool, prefix sharing,
                decode windows, prompt-lookup speculation
  sampling      per-request temperature / top-k / top-p on the device
  eval          perplexity (GPTQ stride protocol)
  cli           ``python -m squeezellm_tpu_torch
                quantize|fisher|eval|benchmark|generate``
  synthetic     random flagship models made on the device
  _build        nvcc build of csrc/*.cu at first use, ctypes binding

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
a kernel wrapper takes its plain version only for CPU tensors.
"""

__version__ = "0.1.0"
