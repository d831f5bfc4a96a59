from .textgen_lstm import TextGenerationLSTM
from .transformer import (PositionalEmbedding, TransformerBlock,
                          TransformerDecodeAdapter, TransformerLM)

__all__ = ["PositionalEmbedding", "TextGenerationLSTM", "TransformerBlock",
           "TransformerDecodeAdapter", "TransformerLM"]
