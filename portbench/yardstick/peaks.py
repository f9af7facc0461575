"""Published peaks of one NVIDIA H100 SXM (dense, without sparsity, at
its full 700 W power limit): the denominators of every roofline and mfu
share the benchmark reports."""

INT8_OPS_PER_S = 1979e12        # int8 tensor-core operations
BF16_FLOPS_PER_S = 989e12       # bf16/fp16 tensor cores
TF32_FLOPS_PER_S = 495e12       # TF32 tensor cores
FP32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12       # HBM3
