"""Models the port serves and trains."""
from .decoder import DecoderBlockLM
from .transformer import MultiHeadSelfAttention, TransformerBlock, TransformerLM

__all__ = ["DecoderBlockLM", "TransformerLM", "TransformerBlock",
           "MultiHeadSelfAttention"]
