from .transformer import build_gpt, sample_next, validate_sampling

__all__ = ["build_gpt", "sample_next", "validate_sampling"]
