from artes_tpu_torch.io.fitsio import read_fits, write_fits  # noqa: F401
