from .ops import LAUNCHES, hf_decode, hf_decode_plain, hf_encode, hf_encode_plain  # noqa: F401
