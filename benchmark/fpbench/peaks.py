"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, 700 W)."""

H100 = {
    "bf16_dense_flops": 989e12,
    "tf32_dense_flops": 495e12,
    "f32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}
