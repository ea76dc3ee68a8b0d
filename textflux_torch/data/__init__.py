from textflux_torch.data.dataset import (  # noqa: F401
    PREFERRED_RESOLUTIONS,
    AnyWordSingleLineDataset,
    CombinedFolderDataset,
    UnionDataset,
    image_resize,
)
from textflux_torch.data.loader import BucketedLoader  # noqa: F401
