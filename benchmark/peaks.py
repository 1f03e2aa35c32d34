"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full 700 W power limit).  Every share the benchmark reports is
taken against these; the run's result carries the card's own power limit
beside them."""

#: Tensor-core matrix rates by compute dtype, FLOP/s.  float32 is the
#: rate outside the tensor cores: the system runs float32 without TF32.
MATMUL_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12, "float32": 67.0e12}
#: float32 rate outside the tensor cores, for elementwise work.
VECTOR_FLOPS = 67.0e12
#: HBM3 bandwidth, bytes/s.
HBM_BYTES_PER_S = 3.35e12
