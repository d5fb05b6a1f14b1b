"""The benchmark's plain reference: frozen copies of the port's plain PyTorch
transport, tables and photometry. Nothing here imports artes_tpu_torch."""
