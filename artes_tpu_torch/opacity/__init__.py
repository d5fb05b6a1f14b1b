from artes_tpu_torch.opacity.base import (  # noqa: F401
    OpacityTable,
    expand_6_to_16,
    normalize_scatter,
    read_opacity_fits,
    write_opacity_fits,
)
