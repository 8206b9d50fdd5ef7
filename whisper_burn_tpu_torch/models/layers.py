"""Basic layers: LayerNorm, GELU, Conv1D (port of models/layers.py).

* LayerNorm: eps=1e-5 inside the sqrt, biased variance over the last dim,
  computed in float32 whatever the activation dtype; kernel J on the card
  (``ops/layer_norm.py``), which folds in the residual add before it
* GELU: ``tanh`` approximation or the exact ``erf`` form
* Conv1D: ``F.conv1d`` in the compute dtype
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.layer_norm import layer_norm  # noqa: F401  (kernel J on the card)

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor, kind: str = "tanh") -> torch.Tensor:
    """GELU: ``kind="tanh"`` (the reference's approximation) or ``"erf"``."""
    if kind == "erf":
        return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    inner = (x + 0.044715 * x * x * x) * _SQRT_2_OVER_PI
    return x * 0.5 * (torch.tanh(inner) + 1.0)


def conv1d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int,
    compute: Compute,
) -> torch.Tensor:
    """``x[B, C_in, T] -> [B, C_out, T_out]``; ``w: [C_out, C_in, k]``."""
    y = F.conv1d(x.to(compute.dtype), w.to(compute.dtype), stride=stride, padding=padding)
    return y + b.to(y.dtype)[None, :, None]
