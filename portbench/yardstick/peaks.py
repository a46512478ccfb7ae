"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit). Shares are stated against these, with the card's power
limit beside them."""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12     # tensor cores, TF32 (the f32 products' peak)
F32_FLOP_PER_S = 67e12       # CUDA cores, f32
