"""The benchmark of tfhe_tpu_torch on one H100 (`python3 -m benchmark.run`)."""
