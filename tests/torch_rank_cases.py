"""Rank programs of the port's multi-process tests
(tests/test_torch_parallel.py).

Run one process a rank by ``qbold_vi_tpu_torch.parallel.multihost.
launch_workers(n, module="torch_rank_cases", args=["--payload", path],
pythonpath=[<tests>])``: gloo on the CPU. This module imports torch and
the port only, never jax: the test computes the JAX references in its
own process and passes each rank its inputs in a pickle of numpy arrays
and port configs. A rank pickles its results to ``<out>.pkl``. Not a test
module (no ``test_`` prefix).
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

torch.set_num_threads(1)


def _tensors(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _tuner(case):
    from qbold_vi_tpu_torch.models.vi import FineTuner

    cfg = case["cfg"]
    tuner = FineTuner(cfg.model, cfg.scan, device="cpu")
    tuner.load_state_dict(_tensors(case["params"]))
    return tuner


def _state(tuner) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in tuner.state_dict().items()}


def ft_step(mesh, case) -> dict:
    """The sharded fine-tune step on the rank's JAX crops and normals."""
    from qbold_vi_tpu_torch.train import optim, steps

    tuner = _tuner(case)
    opt = optim.make_finetune_optimizer(tuner.parameters(), case["cfg"].train)
    m = steps.make_finetune_step(tuner, case["cfg"], opt, mesh)(
        _tensors(case["batch"][mesh.rank]),
        noise=_tensors(case["noise"][mesh.rank]))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _state(tuner)}


def stream_step(mesh, case) -> dict:
    """The sharded streaming step on the rank's JAX draws."""
    from qbold_vi_tpu_torch.train import optim, steps

    tuner = _tuner(case)
    opt = optim.make_pretrain_optimizer(tuner.named_parameters(),
                                        case["cfg"].train)
    m, _ = steps.make_pretrain_stream_step_sharded(
        tuner, case["cfg"], opt, mesh)(draws=case["draws"][mesh.rank],
                                       noise=case["noise"][mesh.rank])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _state(tuner)}


def maps(mesh, case) -> dict:
    """The sharded maps, and save_predictions(mesh=) under a prefix of
    the rank's own."""
    from qbold_vi_tpu_torch import infer

    tuner, cfg = _tuner(case), case["cfg"]
    data, priors = case["data"], case["priors"]
    out = {}
    for first in (True, False):
        out[f"quad_s{1 if first else 2}"] = infer.posterior_maps_sharded(
            tuner, data, mesh, seed=3, use_first_op=first)
    out["mc_s1"] = infer.posterior_maps_sharded(tuner, data, mesh, seed=4,
                                                method="mc", no_samples=8)
    out["elbo_priors"] = infer.elbo_maps_sharded(tuner, cfg, data, priors,
                                                 mesh, seed=5, no_samples=4)
    out["elbo_none"] = infer.elbo_maps_sharded(tuner, cfg, data, None, mesh,
                                               seed=5, no_samples=4)
    out["saved"] = infer.save_predictions(
        tuner, cfg, data, f"{case['prefix']}_{mesh.rank}", seed=6,
        fine_tuned=True, priors=priors, mesh=mesh)
    return out


def trainer(mesh, case) -> dict:
    """Trainer(mesh=): the streaming pretrain, then finetune; what each
    rank logged, its metrics and its weights."""
    from qbold_vi_tpu_torch.train.trainer import Trainer

    logged = []
    t = Trainer(case["cfg"], mesh=mesh,
                logger=lambda *a: logged.append(a[:2]))
    t.pretrain()
    t.finetune(case["data"], study_data=case["data"][:2])
    return {"logged": logged, "pretrain": t.last_pretrain_metrics,
            "finetune": t.last_finetune_metrics, "params": _state(t.tuner),
            "pt_path": t.pt_path, "final_path": t.final_path}


def population(mesh, case) -> list:
    """The sweep's pretrain population with its trials split over the
    ranks (each rank its slice, the metrics gathered)."""
    from qbold_vi_tpu_torch import sweep

    return sweep.population_pretrain(case["cfg"], case["trials"], mesh=mesh,
                                     device="cpu")


def population_full(mesh, case) -> list:
    """The sweep's full-run population (pretrain, fine-tune under kernel
    F's device noise, the ELBO validation) with its trials split over the
    ranks."""
    from qbold_vi_tpu_torch import sweep

    return sweep.population_full_run(case["cfg"], case["trials"], mesh=mesh,
                                     device="cpu")


def main(argv=None) -> int:
    import torch.distributed as dist

    from qbold_vi_tpu_torch.parallel import mesh as pmesh
    from qbold_vi_tpu_torch.parallel.multihost import write_result

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--payload", required=True)
    args = p.parse_args(argv)
    with open(args.payload, "rb") as f:
        cases = pickle.load(f)[args.num_processes]
    pmesh.initialize_distributed(args.coordinator, args.num_processes,
                                 args.process_id, device="cpu")
    try:
        mesh = pmesh.make_mesh("cpu")
        results = {name: globals()[case["kind"]](mesh, case)
                   for name, case in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(args.out + ".pkl", "wb") as f:
        pickle.dump(results, f)
    write_result(args.out, {"cases": sorted(results)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
