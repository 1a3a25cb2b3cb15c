"""Models the port serves."""
from .decoder import DecoderBlockLM

__all__ = ["DecoderBlockLM"]
