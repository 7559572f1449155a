"""qbold_vi_tpu_torch: the PyTorch + CUDA port of qbold_vi_tpu.

Amortized variational inference of OEF, DBV and R2' from ASE qBOLD MRI,
ported from JAX on a TPU to PyTorch with hand-written Hopper (sm_90a)
CUDA kernels. The JAX package ``qbold_vi_tpu`` stays the reference; this
package never imports jax. Ported so far: the full-brain posterior-map
serving path by quadrature or by sampling and the fine-tuned
likelihood/KL/residual export (``infer.posterior_maps``,
``infer.elbo_maps``, ``infer.save_predictions``; kernels A-E), and
two-phase training (``train.trainer.Trainer``): synthetic pretraining and
ELBO fine-tuning (kernels F and G), with the encoder's 3x3 convs by
kernel H under ``fused_conv="on"``. Every TPU kernel of the JAX package
has its hand-written counterpart here.
"""

from .config import OPTIMAL, ModelConfig, QBoldConfig, ScanParams
from .infer import elbo_maps, posterior_maps, save_predictions
from .models.vi import FineTuner, init_params

__version__ = "0.1.0"

__all__ = ["OPTIMAL", "ModelConfig", "QBoldConfig", "ScanParams",
           "FineTuner", "init_params", "posterior_maps", "elbo_maps",
           "save_predictions", "__version__"]
