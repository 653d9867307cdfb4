from .pipelines import PIPELINES, decode, encode, get_pipeline, register_pipeline  # noqa: F401
from .stages import Stage, get_stage, register_stage  # noqa: F401
