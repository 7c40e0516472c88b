"""NLP models of the port (counterpart of ``mxnet_tpu/gluon/model_zoo/nlp``)."""
from .llama import (LlamaAttention, LlamaBlock, LlamaDecodeEngine, LlamaMLP,
                    LlamaModel, RMSNorm, llama_3_8b, llama_tiny)

__all__ = ["RMSNorm", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "LlamaDecodeEngine", "llama_tiny", "llama_3_8b"]
