from .orchestrate import choose_pipeline, encode_auto, portable_pipelines, stream_stats  # noqa: F401
from .pipelines import PIPELINES, decode, encode, get_pipeline, register_pipeline  # noqa: F401
from .stages import Stage, get_stage, register_stage  # noqa: F401
