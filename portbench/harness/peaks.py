"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A card set below 700 W reaches
less; the run prints the card's limit."""

H100 = {
    "fp32_flops": 67e12,       # float32 on the CUDA cores
    "tf32_flops": 495e12,      # tf32 on the tensor cores
    "hbm_bytes": 3.35e12,      # HBM3, bytes a second
}
