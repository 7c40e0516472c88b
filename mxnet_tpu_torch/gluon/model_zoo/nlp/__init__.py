"""NLP models of the port (counterpart of ``mxnet_tpu/gluon/model_zoo/nlp``)."""
from .attention import MultiHeadAttention
from .bert import (BERTEncoder, BERTForPretrainFused, BERTModel,
                   bert_12_768_12, bert_24_1024_16)
from .llama import (LlamaAttention, LlamaBlock, LlamaDecodeEngine, LlamaMLP,
                    LlamaModel, RMSNorm, llama_3_8b, llama_proxy1b,
                    llama_tiny)
from .transformer import PositionwiseFFN, TransformerEncoderCell

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "BERTEncoder", "BERTModel", "BERTForPretrainFused",
           "bert_12_768_12", "bert_24_1024_16",
           "RMSNorm", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "LlamaDecodeEngine", "llama_tiny", "llama_3_8b",
           "llama_proxy1b"]
