"""Logit-Normal / logit-MVN squashing transforms (inference subset).

The counterpart of ``qbold_vi_tpu/dist/logit_mvn.py``. Inference needs
only the raw-head squashes and the logit -> physical transform
(``qbold_vi_tpu/dist/logit_mvn.py:198-233``); sampling, log-probs and the
KL forms come with training.

Parameterisation (the encoder's raw head outputs):
    diag (K=4): [oef_mu, oef_logstd_raw, dbv_mu, dbv_logstd_raw]
    mvg  (K=5): [... , offdiag_raw]
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["LogitMVN"]

OFFDIAG_SCALE = math.exp(-2.0)


@dataclass(frozen=True)
class LogitMVN:
    """Bivariate (OEF, DBV) logit-Normal with optional full covariance."""

    oef_range: float = 0.8
    min_oef: float = 0.04
    dbv_range: float = 0.2
    min_dbv: float = 0.001

    @staticmethod
    def transform_std(raw: torch.Tensor) -> torch.Tensor:
        """Raw head output -> log-std in (-4, 2)."""
        return torch.tanh(raw) * 3.0 - 1.0

    @staticmethod
    def transform_offdiag(raw: torch.Tensor) -> torch.Tensor:
        """Raw head output -> Cholesky off-diagonal in (-e^-2, e^-2)."""
        return torch.tanh(raw) * OFFDIAG_SCALE

    def forward_transform(self, logits: torch.Tensor) -> torch.Tensor:
        """Logit-space (..., 2) -> physical (OEF, DBV) (..., 2)."""
        oef = torch.sigmoid(logits[..., 0:1]) * self.oef_range + self.min_oef
        dbv = torch.sigmoid(logits[..., 1:2]) * self.dbv_range + self.min_dbv
        return torch.cat([oef, dbv], dim=-1)
