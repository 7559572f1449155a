"""The sharded paths run end to end on ``n`` ranks of a tiny
configuration: the port's counterpart of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py:53-333``).

    python -m qbold_vi_tpu_torch dryrun --devices 4 --device cpu

The JAX dry run is one process over a virtual mesh, a mechanism of its
own beside the multi-process certification. In the port one process is
one device, so a dry run of ``n`` devices is ``multihost.certify(n)`` at
the tiny width: ``n`` spawned ranks (gloo on the CPU; on the card as
``parallel/mesh.py`` chooses) held to each other bit for bit and to one
process within rtol 2e-5. The JAX dry run's stages map onto that
workload (``multihost.workload_metrics``):

1 and 2b. one sharded step, on a global batch the mesh does not divide:
   the host-draw sharded steps on ``n + 1`` crops;
2. the sharded epoch with its gradient all-reduce in the HLO: the
   device-draw sharded epochs, the step's gradient reduction counted
   once a step (``step_reduces_per_step``);
2c. subject-sharded on ``n - 1`` subjects: the subject-sharded epoch on
   ``max(1, n - 1)`` subjects, and ``Trainer.finetune`` subject-sharded;
3. kernel F inside the sharded grad: the step with
   ``fused_elbo="host"`` (F's plain version on the CPU);
4. the streaming step and epoch;
5 and 5c. ``posterior_maps_sharded`` and ``elbo_maps_sharded`` of
   ``2n + 1`` subjects (a count the mesh does not divide) against the
   unsharded maps; 5b, kernel B in them: ``fused_infer="auto"`` takes B
   on the card.

5d. the mesh-sharded population sweep: a 2-trial pretrain population
   (``sweep.population_pretrain(mesh=)``), each rank its slice of the
   trials (padded by trial 0 where the ranks outnumber them), every metric
   bit-equal across ranks and within rtol 2e-4 of the population in one
   process.
"""

from __future__ import annotations

__all__ = ["run"]


def run(n_devices: int, *, device: str = "cuda",
        timeout_s: float = 900.0) -> dict:
    """``multihost.certify(n_devices)`` at the tiny width on ``device``
    ranks, with its 2-trial population stage; returns its summary with
    ``devices`` ("ok": True)."""
    from .multihost import certify

    if n_devices < 1:
        raise ValueError("a dry run needs at least one device")
    out = certify(n_devices, width="tiny", device=device,
                  timeout_s=timeout_s, population_trials=2)
    return dict(out, devices=n_devices)
