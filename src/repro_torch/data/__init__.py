from .fields import DATASETS, get_field, load_or_generate, predictor_suite  # noqa: F401
from .realfields import REAL_FIELDS, load_real_fields, real_suite, save_real_fields  # noqa: F401
from .synthetic import Prefetcher, TokenPipeline  # noqa: F401
