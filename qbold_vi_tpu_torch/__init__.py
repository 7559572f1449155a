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
kernel H under ``fused_conv="on"``, with the JAX Trainer's checkpoint
files and their resume (``train/checkpoint.py``), and the command line
``python -m qbold_vi_tpu_torch train | infer | serve | baseline | synth |
export-model | import-weights | transfer`` (``cli.py``), with dropout in
training, the ``torch.export`` serving artifacts (io/export_model.py;
kernel B is the registered op ``qbold_vi_tpu_torch::encode_quad_fused``,
so a process must import this package before it loads a fused artifact),
the legacy Keras ``.h5`` import, tau-protocol transfer and the FSL
MNI-space export, the data-parallel layer (``parallel``) and the
hyperparameter sweep (``sweep``: grid, random and TPE search, populations
of trials, the wandb agent, ``python -m qbold_vi_tpu_torch sweep``). Every
TPU kernel of the JAX package has its hand-written counterpart here, and
every module of it its port.
"""

from .config import OPTIMAL, ModelConfig, QBoldConfig, ScanParams
from .infer import elbo_maps, posterior_maps, save_predictions
from .models.vi import FineTuner, init_params

__version__ = "0.1.0"

__all__ = ["OPTIMAL", "ModelConfig", "QBoldConfig", "ScanParams",
           "FineTuner", "init_params", "posterior_maps", "elbo_maps",
           "save_predictions", "__version__"]
