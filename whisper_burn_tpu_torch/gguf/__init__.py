"""GGUF checkpoint layer: parse, write, quantize, and repack for the port's
kernels (numpy, on the host, once at load time).

Port of ``whisper_burn_tpu/gguf`` (the port's own copy). The loader
(``gguf.loader``: ``LoadedModel``, ``load_whisper_from_gguf``) and the
repacked cache (``gguf.cache``: ``load_whisper``) are imported from their
modules, as in the JAX package.
"""

from whisper_burn_tpu_torch.gguf.quant import (
    Q4_BLOCK_BYTES,
    Q4_BLOCK_SIZE,
    dequantize_q4_0,
    q4_0_nbytes,
    quantize_q4_0,
)
from whisper_burn_tpu_torch.gguf.reader import GgmlDtype, GgufReader, GgufTensorInfo
from whisper_burn_tpu_torch.gguf.repack import QuantizedTensor, repack_q4_0
from whisper_burn_tpu_torch.gguf.writer import GgufWriter

__all__ = [
    "Q4_BLOCK_BYTES",
    "Q4_BLOCK_SIZE",
    "quantize_q4_0",
    "dequantize_q4_0",
    "q4_0_nbytes",
    "GgufReader",
    "GgufTensorInfo",
    "GgmlDtype",
    "GgufWriter",
    "QuantizedTensor",
    "repack_q4_0",
]
