from textflux_torch.evaluation.metrics import (  # noqa: F401
    levenshtein,
    normalized_edit_distance,
    sequence_accuracy,
    evaluate_texts,
)
from textflux_torch.evaluation.crop import crop_polygon_region, min_bounding_rect  # noqa: F401
from textflux_torch.evaluation.fid import frechet_distance, gaussian_stats  # noqa: F401
from textflux_torch.evaluation.inception import (  # noqa: F401
    inception_pool3_features,
    load_inception_extractor,
    make_fid_extractor,
)
