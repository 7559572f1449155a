"""Hyperparameter sweeps: grid, random and Bayesian (TPE) search, trial
populations, and the wandb agent (PyTorch).

The counterpart of ``qbold_vi_tpu/sweep.py`` (reference wandb_sweep.py:36-49
and configurations/sweep_prior.yaml, ``method: bayes`` minimising
``val_elbo``):

* ``run_grid_sweep``: layers x units x seeds, each a fresh run;
* ``random_search`` / ``bayes_search`` over the space grammar (wandb's
  value / values / min-max, or canonical tuples), ``parse_wandb_sweep``
  reading the reference's YAML dicts; a Tree-structured Parzen Estimator
  proposes the Bayesian trials. The grammar and the TPE are numpy, the
  JAX package's code: given the same seed, history and objective values
  they propose the same overrides;
* the objectives: ``_default_run`` (pretrain, then the seed fold's
  validation loss) and ``full_run`` (pretrain, fine-tune on the real
  volumes, the ELBO validation of the study sets) on the port's
  ``Trainer``; ``default_objective`` picks one by the data directory;
* populations: ``population_pretrain`` and ``population_full_run`` train
  P trials together (below);
* ``run_wandb_agent``: an agent of an existing wandb sweep (wandb is
  imported where it is used).

Every entry point runs on the CUDA card unless given ``device="cpu"``.

Populations. Trials whose overrides differ only in per-trial
hyperparameters (``_POP_KEYS``: pt_lr, pt_adamw_decay, inv_gamma_alpha,
inv_gamma_beta; the fine-tune adds ft_lr and adamw_decay) train as one
group; other keys, and the inverse-gamma gate, partition the groups. A
group's parameters, Adam moments and SWA average are tensors with a
leading trial axis, updated for all trials at once by the JAX population's
own formula (scale_by_adam, then ``-lr u - wd p``, the decay masked to the
encoder, with the trial's lr and wd); each trial's FineTuner holds views
of its slice, so each trial's encoder pass is its own, as a serial trial's
is (kernel H, under ``fused_conv="on"``, once a trial). A step draws every
trial's synthetic batch in one launch of kernel S (``synth_batch(seeds=)``,
its trial axis), and a fine-tune step runs kernel F once forward and once
backward on the rows of all trials (``steps.population_finetune_terms``;
kernel G the same way where the configuration routes to it). The seeds of
trial i of a group come from the config seed folded with 1000 + i (its
initial weights), 2000 + i (its pretrain batches) and 3000 + i (its crops
and fine-tune noise), as the JAX keys do. Under device noise kernel F
draws a step's normals under one seed of the group (the config seed
folded with 4000, split by step), trial i's from the Philox counters of
rows i N ...: they too depend on the trial's index alone. ``serial=True``
runs the same algorithm one trial at a time: the equivalence oracle,
draw for draw under either noise. The JAX package vmaps its trial
function; here the trial axis is explicit.

Under a mesh (parallel/mesh.py, one process a device) the trial axis is
split over the ranks: rank r trains its slice of the trials, padded to a
multiple of the world size by repeating trial 0, each trial seeded by its
index in the group, so placement changes no trial's maths; one
``all_gather_rows`` of the stacked metrics gives every rank all P results
in order. No other collective runs.

Deviation from the JAX package, deliberate: an agent batcher whose
executor escapes (an exception past ``_population_batch``'s isolation)
stamps every co-batched entry with a failed result and wakes every waiting
thread, and ``submit`` reads a missing result as a failure -- the JAX
batcher left those threads waiting out ``timeout_s``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .config import QBoldConfig, apply_flat_overrides

__all__ = ["run_grid_sweep", "random_search", "bayes_search",
           "parse_wandb_sweep", "population_pretrain",
           "population_full_run", "run_wandb_agent",
           "full_run", "default_objective"]


def default_objective(cfg: QBoldConfig) -> Callable[..., dict]:
    """``full_run`` when the data directory holds ASE training volumes (the
    reference sweep program, train.py, ranks on the real-data val_elbo),
    else ``_default_run`` (the pretrain objective)."""
    import os
    d = cfg.train.data_directory
    if any(os.path.isfile(os.path.join(d, n))
           for n in ("ASE_scan.npy", "ASE_INF.npy", "ASE_SUP.npy")):
        return full_run
    return _default_run


class _AgentPopulationBatcher:
    """Collects the proposals of N wandb-agent threads and trains each full
    batch as ONE population (the hosted sweep hands an agent one config at
    a time, so batching runs N agent threads that park their proposals
    here).

    ``submit`` blocks the calling thread until its proposal's batch has
    trained and returns that trial's metrics. A batch flushes when
    ``size`` proposals are pending, when every still-live agent thread has
    one parked, when a thread exits (``thread_done``), or after
    ``timeout_s``. Failures isolate per batch as in _population_batch; an
    executor that escapes still stamps every entry of its batch failed and
    wakes every waiting thread."""

    def __init__(self, cfg: QBoldConfig, pop_fn: Callable, size: int,
                 n_threads: int, timeout_s: float = 300.0):
        import threading
        self._cfg, self._pop_fn = cfg, pop_fn
        self._size, self._timeout = size, timeout_s
        self._live = n_threads
        self._cond = threading.Condition()
        self._pending: list[dict] = []     # {"ov", "result"}
        self._count = 0

    def submit(self, overrides: dict) -> dict:
        import time as _time
        with self._cond:
            entry = {"ov": dict(overrides), "result": None}
            self._pending.append(entry)
            if len(self._pending) >= min(self._size, max(self._live, 1)):
                self._flush_locked()
            else:
                deadline = _time.monotonic() + self._timeout
                while entry["result"] is None:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        if entry in self._pending:
                            self._flush_locked()
                        break
                    self._cond.wait(remaining)
            if entry["result"] is None:
                return _failed("the population batch returned no result",
                               entry["ov"])
            return entry["result"]

    def thread_done(self) -> None:
        """An agent thread ran out of assignments: it can no longer
        contribute to a batch, so shrink the flush threshold and flush
        any parked stragglers at once."""
        with self._cond:
            self._live -= 1
            if self._pending and len(self._pending) >= max(self._live, 1):
                self._flush_locked()

    def _flush_locked(self) -> None:
        batch = self._pending
        self._pending = []
        outs: list = []
        try:
            outs = _population_batch(self._cfg, [e["ov"] for e in batch],
                                     self._count, self._pop_fn)
        finally:
            self._count += len(batch)
            for j, e in enumerate(batch):
                out = outs[j] if j < len(outs) else None
                e["result"] = (out if out is not None else _failed(
                    "the population executor raised", e["ov"]))
            self._cond.notify_all()


def _failed(error: str, overrides: dict) -> dict:
    return {"status": "failed", "error": error, "overrides": overrides}


def run_wandb_agent(sweep_id: str, cfg: QBoldConfig,
                    count: Optional[int] = None,
                    run_fn: Optional[Callable[[QBoldConfig], dict]] = None,
                    metric: str = "val_elbo",
                    wandb_module: Any = None,
                    parallel_trials: int = 1, mesh=None,
                    device=None) -> int:
    """Attach to an EXISTING wandb sweep service as an agent (reference
    configurations/sweep_prior.yaml:1-6, wandb_sweep.py:36-49,
    train.py:482-488): wandb proposes, the trial trains here, the metric
    is logged back. ``wandb_module`` injects a stand-in; otherwise wandb is
    imported here. Returns the number of trials run.

    ``parallel_trials > 1``: trials train as populations. The hosted sweep
    hands each agent one config at a time, so ``parallel_trials`` agent
    threads park their proposals in an _AgentPopulationBatcher and train
    together; every run still logs its own metric and finishes on its own
    (this needs a wandb with concurrently open runs). The default
    objective and full_run batch; a custom run_fn runs serially, with a
    warning."""
    wandb = wandb_module
    if wandb is None:                       # pragma: no cover - needs wandb
        import wandb as wandb
    objective = default_objective(cfg)
    run_fn = run_fn or objective
    import threading as _threading
    done = {"n": 0}
    done_lock = _threading.Lock()

    pop_fn = None
    if parallel_trials > 1:
        pop_fn = _population_fn_for(
            None if run_fn is _default_run else run_fn, parallel_trials,
            mesh, device)
        if pop_fn is None:
            import warnings
            warnings.warn(
                "parallel_trials > 1 but the objective has no population "
                "executor; agent trials run serially", stacklevel=2)
    serial_fn = _on_device(run_fn, device)

    def _run_one(run) -> tuple[dict, int]:
        """Serial executor: the run_fn flow for one proposed config, in a
        directory keyed on the wandb run id (a local counter resets on an
        agent restart, and a reused directory resumes another trial)."""
        overrides = dict(run.config)
        run_key = getattr(run, "id", None) or done["n"]
        run_dir = overrides.pop("save_directory",
                                f"{cfg.train.save_directory}/agent"
                                f"_{run_key}")
        overrides["save_directory"] = run_dir
        return serial_fn(apply_flat_overrides(cfg, overrides)), 0

    def _run_batched(run) -> tuple[dict, int]:
        """Population executor: park the proposal and train with the batch
        (in memory: no run directory)."""
        overrides = dict(run.config)
        overrides.pop("save_directory", None)
        out = batcher.submit(overrides)
        return out, (1 if out.get("status") == "failed" else 0)

    def _one_trial():
        run = wandb.init()
        exit_code = 0
        try:
            out, exit_code = (_run_batched if pop_fn is not None
                              else _run_one)(run)
            metrics = {k: float(v) for k, v in out.items()
                       if isinstance(v, (int, float, np.floating))}
            if metric not in metrics and "val_loss" in metrics:
                metrics[metric] = metrics["val_loss"]
            run.log(metrics)
        except Exception as e:  # noqa: BLE001 -- one failing proposal
            # must not end the agent session, and the hosted sweep must
            # see the run FAIL to learn the config was bad
            exit_code = 1
            run.log({"status": "failed",
                     "error": f"{type(e).__name__}: {e}"})
            import sys
            print(f"sweep agent trial failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
        finally:
            with done_lock:
                done["n"] += 1
            _finish_wandb_run(run, exit_code)

    if pop_fn is None:
        wandb.agent(sweep_id, function=_one_trial, count=count)
        return done["n"]

    n_threads = parallel_trials if count is None else min(parallel_trials,
                                                          count)
    batcher = _AgentPopulationBatcher(cfg, pop_fn, parallel_trials,
                                      n_threads)
    # the trial budget split over the agent threads (the service stops
    # assigning runs when the sweep is done regardless)
    shares = None if count is None else [
        count // n_threads + (i < count % n_threads)
        for i in range(n_threads)]

    def _agent_thread(i):
        try:
            wandb.agent(sweep_id, function=_one_trial,
                        count=None if shares is None else shares[i])
        finally:
            batcher.thread_done()

    threads = [_threading.Thread(target=_agent_thread, args=(i,),
                                 name=f"qbold-sweep-agent-{i}", daemon=True)
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return done["n"]


def _finish_wandb_run(run, exit_code: int) -> None:
    """finish() the run, passing exit_code where the API takes it; the
    support is read from the signature, so that a TypeError raised inside
    finish() is never taken for a refused keyword (which would finish the
    run twice)."""
    try:
        import inspect

        params = inspect.signature(run.finish).parameters
        has_kwarg = ("exit_code" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in params.values()))
    except (TypeError, ValueError):  # C-impl / mock signatures
        has_kwarg = True
    if has_kwarg:
        try:
            run.finish(exit_code=exit_code)
        except TypeError as te:
            # only a refused keyword binding (no frames past the call
            # site: finish() never ran) falls back to the bare call
            binding_failure = (te.__traceback__ is not None
                               and te.__traceback__.tb_next is None)
            kwarg_msg = ("exit_code" in str(te)
                         or "unexpected keyword" in str(te))
            if not (binding_failure and kwarg_msg):
                raise
            has_kwarg = False
    if not has_kwarg:
        if exit_code:
            import sys

            print("wandb run.finish() lacks exit_code: the failed trial "
                  "will appear finished to the hosted sweep",
                  file=sys.stderr)
        run.finish()


# ---- populations --------------------------------------------------------------

_POP_KEYS = ("pt_lr", "pt_adamw_decay", "inv_gamma_alpha", "inv_gamma_beta")
# per-trial hyperparameters of the fine-tune phase as well
_POP_FT_KEYS = _POP_KEYS + ("ft_lr", "adamw_decay")
_PT_METRICS = ("val_loss", "oef_mse", "dbv_mse", "r2p_mse", "loss")
_FT_METRICS = ("val_nll", "val_kl", "val_smoothness", "val_smoothness_scaled",
               "val_elbo", "val_elbo_smooth", "loss")


def _ig_on(cfg: QBoldConfig, ov: dict) -> bool:
    return (float(ov.get("inv_gamma_alpha", cfg.train.inv_gamma_alpha))
            * float(ov.get("inv_gamma_beta", cfg.train.inv_gamma_beta)) > 0)


def _groups(cfg: QBoldConfig, overrides_list: Sequence[dict],
            traced: tuple) -> dict:
    """{(static overrides, inverse-gamma gate): [trial indices]}: trials
    that differ only in ``traced`` keys share a group; the inverse-gamma
    gate partitions them too (a group computes the prior for all its
    trials or for none)."""
    groups: dict[tuple, list[int]] = {}
    for i, ov in enumerate(overrides_list):
        static = tuple(sorted((k, v) for k, v in ov.items()
                              if k not in traced))
        groups.setdefault((static, _ig_on(cfg, ov)), []).append(i)
    return groups


def _col(trial_ovs: Sequence[dict], key: str, default) -> list:
    """The trials' values of ``key``, each rounded to float32 as the JAX
    population's traced (P,) arrays hold them."""
    return [float(np.float32(float(ov.get(key, default))))
            for ov in trial_ovs]


def population_pretrain(cfg: QBoldConfig, overrides_list: Sequence[dict],
                        vol_shape=(10, 10, 5), serial: bool = False,
                        mesh=None, *, device=None) -> list:
    """Every trial's PRETRAIN objective, a group of trials at a time (the
    module docstring): the streaming pretrain -- ``no_pt_epochs`` x
    round(0.9 sample_size^2 / voxels a volume / pt_batch_size) steps, every
    trial's batch a step in one launch of kernel S -- then each trial's
    validation on the fixed seed fold every serial trial ranks on
    (trainer.pretrain_val_fold), under the trial's own hyperparameters and
    one fixed seed, so identical weights score identically.

    ``mesh`` splits each group's trial axis over the ranks; ``serial=True``
    runs the trials one at a time (the oracle).

    Returns one metrics dict per trial, in order: {val_elbo, val_loss,
    oef_mse, dbv_mse, r2p_mse, loss}."""
    results: list[Optional[dict]] = [None] * len(overrides_list)
    for (static, _), idxs in _groups(cfg, overrides_list, _POP_KEYS).items():
        run_cfg = apply_flat_overrides(cfg, dict(static))
        outs = _population_group(
            run_cfg, [overrides_list[i] for i in idxs], vol_shape, serial,
            mesh=mesh, device=device)
        for i, out in zip(idxs, outs):
            results[i] = out
    return results


def _pad_trials(p_n: int, n_dev: int) -> int:
    """The trial axis rounded up to a multiple of the mesh size (pad trials
    repeat trial 0; their results are sliced off)."""
    return -(-p_n // n_dev) * n_dev


def _population_dispatch(run_trials: Callable, p_n: int, mesh,
                         serial: bool) -> np.ndarray:
    """The (p_n, K) metrics of ``run_trials(indices) -> (len, K) tensor``
    over a group's trials: all at once, one at a time (``serial``), or
    under ``mesh`` the rank's slice of the padded trial axis, gathered
    from every rank in order (one all_gather)."""
    if serial:
        rows = torch.cat([run_trials([i]) for i in range(p_n)])
    elif mesh is None or mesh.world_size == 1:
        rows = run_trials(list(range(p_n)))
    else:
        from .parallel import mesh as pmesh

        per = _pad_trials(p_n, mesh.world_size) // mesh.world_size
        local = [i if i < p_n else 0
                 for i in range(mesh.rank * per, (mesh.rank + 1) * per)]
        rows = pmesh.all_gather_rows(mesh, run_trials(local))[:p_n]
    return rows.detach().cpu().numpy()


class _Population:
    """The trials ``idx`` of a group: parameters with a leading trial axis
    (``stacked``), one FineTuner a trial holding views of its slice, and
    the per-trial hyperparameters."""

    def __init__(self, cfg: QBoldConfig, trial_ovs: Sequence[dict],
                 idx: Sequence[int], device):
        from torch import nn

        from .models.vi import FineTuner, init_params
        from .train.steps import fold_seed

        tr = cfg.train
        self.cfg, self.idx, self.device = cfg, list(idx), device
        ovs = [trial_ovs[i] for i in self.idx]
        col = lambda k, d: torch.tensor(_col(ovs, k, d),     # noqa: E731
                                        device=device)
        self.pt_lr = col("pt_lr", tr.pt_lr)
        self.pt_wd = (col("pt_adamw_decay", tr.pt_adamw_decay) if tr.use_swa
                      else torch.zeros(len(ovs), device=device))
        self.ft_lr = col("ft_lr", tr.ft_lr)
        self.ft_wd = col("adamw_decay", tr.adamw_decay)
        ia, ib = (_col(ovs, "inv_gamma_alpha", tr.inv_gamma_alpha),
                  _col(ovs, "inv_gamma_beta", tr.inv_gamma_beta))
        gates = {a * b > 0 for a, b in zip(ia, ib)}
        if len(gates) > 1:
            raise ValueError(
                "population batch mixes trials with and without the "
                "inverse-gamma prior -- call via population_pretrain, "
                "which partitions on it")
        if not (gates == {True} or cfg.model.infer_inv_gamma):
            ia, ib = [0.0] * len(ovs), [0.0] * len(ovs)
        # trial j's own configuration: its inverse-gamma prior
        self.cfgs = [dataclasses.replace(cfg, train=dataclasses.replace(
            tr, inv_gamma_alpha=a, inv_gamma_beta=b)) for a, b in zip(ia, ib)]
        inits = [init_params(
            cfg.model, cfg.scan,
            torch.Generator().manual_seed(fold_seed(tr.seed, 1000 + i)))
            for i in self.idx]
        self.stacked = {k: torch.stack([torch.as_tensor(s[k]) for s in inits])
                        .to(device=device, dtype=torch.float32)
                        for k in inits[0]}
        self.tuners = []
        for j in range(len(self.idx)):
            t = FineTuner(cfg.model, cfg.scan, device=device,
                          full_model=tr.full_model, use_blood=tr.use_blood)
            for name, full in self.stacked.items():
                path, _, leaf = name.rpartition(".")
                mod = t.get_submodule(path) if path else t
                mod._parameters[leaf] = nn.Parameter(full[j])
            self.tuners.append(t)
        # the decay of pretraining reaches the encoder only
        self.encoder_only = {k: k.startswith("encoder.") for k in self.stacked}

    def grads(self) -> dict:
        """The trials' gradients stacked like the parameters (zeros where a
        loss does not reach a parameter, JAX's zero cotangent)."""
        out = {}
        for name, full in self.stacked.items():
            gs = []
            for t in self.tuners:
                p = t.get_parameter(name)
                gs.append(p.grad if p.grad is not None
                          else torch.zeros_like(p))
                p.grad = None
            out[name] = torch.stack(gs)
        return out


class _StackedAdam:
    """optax.scale_by_adam on stacked parameters, then ``-lr u - wd p``
    with the trials' (P,) lr and wd (the decay where ``decay[name]``):
    the JAX population's update, every trial at once."""

    def __init__(self, stacked: dict, b2: float, b1: float = 0.9,
                 eps: float = 1e-7):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in stacked.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in stacked.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, stacked: dict, grads: dict, lr: torch.Tensor,
             wd: torch.Tensor, decay: Optional[dict] = None) -> None:
        t = self.count + 1
        c1 = float(1.0 - np.float32(self.b1) ** np.float32(t))
        c2 = float(1.0 - np.float32(self.b2) ** np.float32(t))
        for k, p in stacked.items():
            g, mu, nu = grads[k], self.mu[k], self.nu[k]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            shape = (-1,) + (1,) * (p.dim() - 1)
            update = -lr.reshape(shape) * u
            if decay is None or decay[k]:
                update = update - wd.reshape(shape) * p
            p.add_(update)
        self.count = t


def _pretrain_population(cfg: QBoldConfig, trial_ovs: Sequence[dict],
                         idx: Sequence[int], vol_shape, device) -> tuple:
    """(population, metrics (len(idx), len(_PT_METRICS)) tensor) of the
    streaming pretrain of the trials ``idx`` of a group."""
    from .models.encoder import _full_fp32
    from .ops.synth_batch import synth_batch
    from .train import steps
    from .train.optim import swa_init, swa_update
    from .train.trainer import pretrain_val_fold, val_batch_count

    tr = cfg.train
    pop = _Population(cfg, trial_ovs, idx, device)
    p_n = len(pop.idx)
    vol = int(np.prod(vol_shape))
    n_steps = tr.no_pt_epochs * max(1, round(
        0.9 * cfg.synth.sample_size ** 2 / vol / tr.pt_batch_size))
    step_seeds = [steps._split_seed(steps.fold_seed(tr.seed, 2000 + i),
                                    n_steps) for i in pop.idx]
    adam = _StackedAdam(pop.stacked, b2=0.999)
    swa = swa_init(pop.stacked.items()) if tr.use_swa else None
    losses = None
    for i in range(n_steps):
        split = [steps._split_seed(s[i], 2) for s in step_seeds]
        batch = synth_batch(cfg, tr.pt_batch_size,
                            seeds=[s[0] for s in split], device=device,
                            vol_shape=vol_shape)
        with _full_fp32():
            losses = torch.stack([steps.pretrain_loss(
                pop.tuners[j], pop.cfgs[j],
                {"x": batch["x"][j], "y": batch["y"][j]}, seed=split[j][1])
                for j in range(p_n)])
            torch.sum(losses).backward()
        adam.step(pop.stacked, pop.grads(), pop.pt_lr, pop.pt_wd,
                  pop.encoder_only)
        if swa is not None:
            swa = swa_update(swa, pop.stacked.items(), tr.swa_start,
                             tr.swa_period)
    if tr.swa_adopt and swa is not None and swa.n_avg > 0:
        with torch.no_grad():
            for k, p in pop.stacked.items():
                p.copy_(swa.average[k])
    vx, vy = pretrain_val_fold(cfg, device)
    n_val = val_batch_count(len(vx), int(np.prod(vx.shape[1:4])))
    val = {"x": torch.from_numpy(np.ascontiguousarray(vx[:n_val])).to(device),
           "y": torch.from_numpy(np.ascontiguousarray(vy[:n_val])).to(device)}
    rows = []
    for j in range(p_n):
        m = steps.make_pretrain_eval(pop.tuners[j], pop.cfgs[j])(val, 0)
        m["loss"] = losses[j].detach()
        rows.append(torch.stack([m[k].reshape(()) for k in _PT_METRICS]))
    return pop, torch.stack(rows)


def _population_group(cfg: QBoldConfig, trial_ovs: Sequence[dict],
                      vol_shape, serial: bool, mesh=None,
                      device=None) -> list:
    """The pretrain population of one group: one metrics dict a trial."""
    device = torch.device("cuda" if device is None else device)
    stacked = _population_dispatch(
        lambda idx: _pretrain_population(cfg, trial_ovs, idx, vol_shape,
                                         device)[1],
        len(trial_ovs), mesh, serial)
    results = []
    for row in stacked:
        m = {k: float(v) for k, v in zip(_PT_METRICS, row)}
        m["val_elbo"] = m["val_loss"]
        results.append(m)
    return results


def population_full_run(cfg: QBoldConfig, overrides_list: Sequence[dict],
                        serial: bool = False, mesh=None, *,
                        device=None) -> list:
    """The reference's sweep program -- pretrain, fine-tune on the real
    volumes, rank on the ELBO validation of the study sets (sweep_prior.yaml
    ``program: train.py``, reference train.py:188-282,325-359) -- a group
    of trials at a time (the module docstring). Per trial: the pretrain
    population; per-voxel priors from the trial's own pretrained encoder
    (stream 1 on the masked volumes, reference train.py:26-31); the
    fine-tune schedule (``no_ft_epochs`` x ``ft_steps_per_epoch`` steps of
    ``ft_batch_size`` crops drawn from the trial's generator, the
    trial's ft_lr and adamw_decay decaying linearly to /100,
    scale_by_adam with b2 0.9), kernel F once forward and once backward a
    step for all trials; then the ELBO validation over at most 4 batches
    of ``eval_batch_size`` subjects in order, each the fixed top-left
    76-voxel window (Trainer._elbo_eval's), under fixed seeds.

    Deviations from the Trainer-driven full_run, as the JAX package's: the
    pretrain streams its batches; the crops come from each trial's seeded
    generator; adamw_decay 0 keeps the AdamW form (b2 0.9). Without study
    sets the ELBO validation runs over the training volumes, under
    ``train_*`` keys mirrored to val_elbo.

    Returns one metrics dict a trial: {val_elbo, val_nll, val_kl,
    val_smoothness, ..., loss, pt_val_loss, status}."""
    from .train import data as data_pipe

    real = data_pipe.load_real_directory(cfg.train.data_directory)
    if real["train"] is None:
        raise FileNotFoundError(
            f"population_full_run needs ASE training volumes under "
            f"{cfg.train.data_directory!r} (ASE_scan.npy / ASE_INF.npy / "
            f"ASE_SUP.npy -- reference train.py:208-214)")
    if real["study"] is None:
        import warnings
        warnings.warn(
            "no hyperv_ase.npy/baseline_ase.npy study sets: ranking on "
            "the ELBO over the TRAINING volumes (train_* keys, mirrored "
            "to val_elbo)", stacklevel=2)
    results: list[Optional[dict]] = [None] * len(overrides_list)
    for (static, _), idxs in _groups(cfg, overrides_list,
                                     _POP_FT_KEYS).items():
        run_cfg = apply_flat_overrides(cfg, dict(static))
        outs = _population_full_group(
            run_cfg, [overrides_list[i] for i in idxs], real["train"],
            real["study"], serial, mesh=mesh, device=device)
        for i, out in zip(idxs, outs):
            results[i] = out
    return results


def _finetune_step(pop: _Population, cfg: QBoldConfig, adam: _StackedAdam,
                   batches: list, seeds: list, device_seed: int, step: int,
                   total: int) -> torch.Tensor:
    """One fine-tune step of every trial of ``pop`` (kernel F once forward
    and once backward for all of them, under device noise from the group's
    ``device_seed``), then the update with each trial's lr and decay at
    ``step`` of ``total``, both decaying linearly to /100 (the traced form
    of optim.make_finetune_optimizer). Returns the trials' losses (P,)."""
    from .models.encoder import _full_fp32
    from .train import steps

    with _full_fp32():
        terms = steps.population_finetune_terms(
            pop.tuners, cfg, batches, seeds=seeds, device_seed=device_seed,
            first_trial=pop.idx[0])
        losses = torch.stack([t[0] for t in terms])
        torch.sum(losses).backward()
    frac = (torch.tensor(step, dtype=torch.float32) / float(total)).to(
        pop.device)
    lr = pop.ft_lr + (pop.ft_lr / 100.0 - pop.ft_lr) * frac
    wd = pop.ft_wd + (pop.ft_wd / 100.0 - pop.ft_wd) * frac
    adam.step(pop.stacked, pop.grads(), lr, wd)
    return losses.detach()


def _population_full_group(cfg: QBoldConfig, trial_ovs: Sequence[dict],
                           real_train, study, serial: bool, mesh=None,
                           device=None) -> list:
    from .train import data as data_pipe
    from .train import steps

    device = torch.device("cuda" if device is None else device)
    tr = cfg.train
    p_n = len(trial_ovs)
    k_prior = 5 if cfg.model.use_mvg else 4
    vols = torch.from_numpy(data_pipe.blank_crop(real_train)).to(device)
    evals = (torch.from_numpy(np.float32(study)).to(device)
             if study is not None else vols)
    prefix = "val_" if study is not None else "train_"
    total = tr.no_ft_epochs * tr.ft_steps_per_epoch
    b_eval = tr.eval_batch_size
    n_full = evals.shape[0] // b_eval
    # Trainer._elbo_eval's batches: subjects in order, the top-left 76
    # window, at most 4 batches (reference train.py:70,238,333)
    ecx, ecy = min(76, evals.shape[1]), min(76, evals.shape[2])
    eval_slices = ([(0, evals.shape[0])] if n_full == 0 else
                   [(i * b_eval, b_eval) for i in range(min(4, n_full))])
    # the group's device-noise seeds, one a step (the same on every rank)
    device_seeds = steps._split_seed(steps.fold_seed(tr.seed, 4000), total)

    @torch.no_grad()
    def prior_maps(tuner, volumes):
        mask = volumes[..., -1:]
        return tuner.encode(volumes[..., :-1] * mask)[0][..., :k_prior]

    def run(idx):
        pop, pt_rows = _pretrain_population(cfg, trial_ovs, idx, (10, 10, 5),
                                            device)
        priors = [prior_maps(t, vols) for t in pop.tuners]
        eval_priors = [prior_maps(t, evals) for t in pop.tuners]
        gens = [torch.Generator().manual_seed(
            steps.fold_seed(tr.seed, 3000 + i)) for i in pop.idx]
        adam = _StackedAdam(pop.stacked, b2=0.9)
        losses = None
        for step in range(total):
            batches, seeds = [], []
            for j in range(len(pop.idx)):
                batches.append(steps.sample_crop_batch(
                    gens[j], vols, priors[j], tr.ft_batch_size, tr.crop_size))
                seeds.append(int(torch.randint(0, steps._SEED_HI, (1,),
                                               generator=gens[j])))
            losses = _finetune_step(pop, cfg, adam, batches, seeds,
                                    device_seeds[step], step, total)
        rows = []
        for j, tuner in enumerate(pop.tuners):
            evaluate = steps.make_finetune_eval(tuner, cfg)
            outs = []
            for bi, (lo, n) in enumerate(eval_slices):
                vol_b = evals[lo:lo + n, :ecx, :ecy]
                mask = vol_b[..., -1:]
                batch = {"images": vol_b[..., :-1] * mask, "mask": mask,
                         "priors": eval_priors[j][lo:lo + n, :ecx, :ecy]}
                outs.append(evaluate(batch, steps.fold_seed(0, bi)))
            m = {k: torch.mean(torch.stack([o[k] for o in outs]))
                 for k in _FT_METRICS if k != "loss"}
            m["loss"] = losses[j]
            rows.append(torch.stack([m[k] for k in _FT_METRICS]))
        return torch.cat([pt_rows, torch.stack(rows)], 1)

    stacked = _population_dispatch(run, p_n, mesh, serial)
    results = []
    n_pt = len(_PT_METRICS)
    for i in range(p_n):
        m = {(k if k == "loss" else k.replace("val_", prefix)): float(v)
             for k, v in zip(_FT_METRICS, stacked[i, n_pt:])}
        m["pt_val_loss"] = float(stacked[i, 0])
        m["val_elbo"] = m[prefix + "elbo"]
        m["status"] = "FULL_TRAINED"
        results.append(m)
    return results


# ---- serial objectives -----------------------------------------------------------

def _on_device(run_fn: Callable, device) -> Callable:
    """The port's objectives given ``device``; a caller's own run_fn as it
    is."""
    import functools

    if device is not None and run_fn in (_default_run, full_run):
        return functools.partial(run_fn, device=device)
    return run_fn


def _default_run(cfg: QBoldConfig, device=None) -> dict:
    """The out-of-the-box objective: pretrain, then the held-out synthetic
    validation loss (a negative log-likelihood on held-out voxels) under
    the ranking key ``val_elbo``, on the seed fold every trial ranks on
    (``pretrain_val_metrics(fold=True)``, whatever the pretrain mode and
    whether the trial was resumed)."""
    from .train.trainer import Trainer, _stdout_logger

    trainer = Trainer(cfg, device=device)
    trainer.pretrain()
    out: dict = {"status": trainer.status.name}
    m = trainer.pretrain_val_metrics(fold=True)
    _stdout_logger("sweep-eval", 0, m)
    out.update(m)
    out["val_elbo"] = out["val_loss"]
    return out


def full_run(cfg: QBoldConfig, device=None) -> dict:
    """The reference's sweep program: pretrain, fine-tune on the real
    volumes under ``data_directory``, rank on the ELBO validation's
    ``val_elbo`` over the held-out study sets (reference
    train.py:188-282,325-359). Without study sets the same ELBO pass runs
    over the blank-cropped training volumes, reported under ``train_*``
    keys with ``val_elbo`` mirrored, with a warning, so that every trial
    carries a ranking metric."""
    import warnings

    from .train import data as data_pipe
    from .train.trainer import Trainer, _stdout_logger

    real = data_pipe.load_real_directory(cfg.train.data_directory)
    if real["train"] is None:
        raise FileNotFoundError(
            f"full_run sweep objective needs ASE training volumes under "
            f"{cfg.train.data_directory!r} (ASE_scan.npy / ASE_INF.npy / "
            f"ASE_SUP.npy -- reference train.py:208-214)")
    trainer = Trainer(cfg, device=device)
    trainer.pretrain()
    trainer.finetune(real["train"], study_data=real["study"])
    out: dict = {"status": trainer.status.name}
    if real["study"] is not None:
        m = trainer.finetune_val_metrics(real["study"])
        _stdout_logger("sweep-eval", 0, m)
        out.update({k: float(v) for k, v in m.items()})
    else:
        warnings.warn(
            "no hyperv_ase.npy/baseline_ase.npy study sets: ranking on "
            "the ELBO over the TRAINING volumes (train_* keys, mirrored "
            "to val_elbo)", stacklevel=2)
        m = trainer.finetune_val_metrics(
            data_pipe.blank_crop(real["train"]))
        _stdout_logger("sweep-eval", 0, m)
        out.update({k.replace("val_", "train_"): float(v)
                    for k, v in m.items()})
        out["val_elbo"] = out["train_elbo"]
    return out


def run_grid_sweep(cfg: QBoldConfig,
                   layers: Sequence[int] = (2, 4, 6, 8, 10),
                   units: Sequence[int] = (2, 4, 6, 8, 10),
                   seeds: int = 3,
                   run_fn: Optional[Callable[[QBoldConfig], dict]] = None,
                   *, device=None) -> list:
    """layers x units x seeds grid (reference wandb_sweep.py:36-49), each a
    fresh run in a directory of its own."""
    run_fn = _on_device(run_fn or _default_run, device)
    results = []
    for nl, nu, seed in itertools.product(layers, units, range(seeds)):
        run_cfg = apply_flat_overrides(cfg, {
            "no_intermediate_layers": nl,
            "no_units": nu,
            "save_directory": f"{cfg.train.save_directory}/l{nl}_u{nu}_s{seed}",
        })
        run_cfg = dataclasses.replace(
            run_cfg, train=dataclasses.replace(run_cfg.train, seed=seed),
            name=f"{nl}_layers_{nu}_units_{seed}")
        out = run_fn(run_cfg)
        out.update(layers=nl, units=nu, seed=seed)
        results.append(out)
    return results


# ---- search-space grammar ----------------------------------------------------------
#
# Canonical spec per key (normalised by _normalise_space):
#   ("fixed", v)              always v (wandb `value:`)
#   ("choice", [v, ...])      categorical (wandb `values:` / a list)
#   ("uniform", lo, hi)       continuous U(lo, hi) (wandb `min:`/`max:`)
#   ("log_uniform", lo, hi)   exp(U(ln lo, ln hi)), for scale parameters


def _normalise_space(space: dict) -> dict:
    out = {}
    for k, spec in space.items():
        if isinstance(spec, tuple) and spec and spec[0] in (
                "fixed", "choice", "uniform", "log_uniform"):
            out[k] = spec
        elif isinstance(spec, dict):
            # wandb parameter grammar (reference sweep_prior.yaml)
            if "value" in spec:
                out[k] = ("fixed", spec["value"])
            elif "values" in spec:
                out[k] = ("choice", list(spec["values"]))
            elif "min" in spec and "max" in spec:
                kind = ("log_uniform"
                        if spec.get("distribution", "").startswith("log")
                        else "uniform")
                out[k] = (kind, float(spec["min"]), float(spec["max"]))
            else:
                raise ValueError(f"unsupported wandb parameter spec "
                                 f"for {k!r}: {spec}")
        elif (isinstance(spec, (list, tuple)) and len(spec) == 2
              and all(isinstance(v, (int, float))
                      and not isinstance(v, bool) for v in spec)):
            out[k] = ("uniform", float(spec[0]), float(spec[1]))
        elif isinstance(spec, (list, tuple)):
            out[k] = ("choice", list(spec))
        else:
            out[k] = ("fixed", spec)
    return out


def _check_space_keys(space: dict) -> None:
    """Reject unknown search-space dimensions before any trial runs: a
    typo'd key would fail every trial (or, permissively, train every
    trial on the same config)."""
    from .config import _unknown_key_error, known_flat_keys

    known = known_flat_keys()
    for key in space:
        if key not in known:
            raise _unknown_key_error(
                key, remedy="fix the search-space dimension name -- a "
                            "sweep over an unroutable key would train "
                            "every trial on the same config")


def parse_wandb_sweep(spec: dict) -> tuple[dict, str, str, str]:
    """A reference-style wandb sweep dict (reference
    configurations/sweep_prior.yaml:1-51) -> (space, metric_name, goal,
    method)."""
    space = _normalise_space(spec.get("parameters", {}))
    metric = spec.get("metric", {}) or {}
    return (space,
            metric.get("name", "val_elbo"),
            metric.get("goal", "minimize"),
            spec.get("method", "bayes"))


def _draw(rng: np.random.Generator, spec: tuple):
    kind = spec[0]
    if kind == "fixed":
        return spec[1]
    if kind == "choice":
        return spec[1][int(rng.integers(len(spec[1])))]
    if kind == "uniform":
        return float(rng.uniform(spec[1], spec[2]))
    if kind == "log_uniform":
        return float(math.exp(rng.uniform(math.log(spec[1]),
                                          math.log(spec[2]))))
    raise ValueError(kind)


def _population_batch(cfg: QBoldConfig, batch: Sequence[dict],
                      lo: int, pop_fn: Callable = None) -> list:
    """One population batch with _run_trial's failure isolation: a batch
    that raises retries its trials one at a time, on the same device and
    the same kernels, so that a bad trial fails alone and ranks last."""
    import sys
    if pop_fn is None:
        pop_fn = population_pretrain
    try:
        outs = list(pop_fn(cfg, list(batch)))
    except Exception as e:                    # noqa: BLE001 - see docstring
        print(f"[sweep] population batch at trial {lo} FAILED "
              f"({type(e).__name__}: {e}); retrying trials serially",
              file=sys.stderr)
        outs = []
        for j, ov in enumerate(batch):
            try:
                outs.append(pop_fn(cfg, [ov])[0])
            except Exception as e2:           # noqa: BLE001
                print(f"[sweep] trial {lo + j} FAILED "
                      f"({type(e2).__name__}: {e2}); ranking last",
                      file=sys.stderr)
                outs.append({"status": "failed",
                             "error": f"{type(e2).__name__}: {e2}"})
    for j, out in enumerate(outs):
        out.update(trial=lo + j, overrides=batch[j])
    return outs


def _population_fn_for(run_fn: Optional[Callable], parallel_trials: int,
                       mesh=None, device=None) -> Optional[Callable]:
    """The population executor of a sweep, or None to run serially: the
    default objective (run_fn None) -> population_pretrain, full_run ->
    population_full_run; a custom run_fn runs serially. Looked up in the
    module's globals, so a test's monkeypatch reaches it."""
    if parallel_trials <= 1:
        return None
    import functools
    import sys
    mod = sys.modules[__name__]
    if run_fn is None:
        fn = mod.population_pretrain
    elif run_fn is mod.full_run:
        fn = mod.population_full_run
    else:
        return None
    kw = {k: v for k, v in (("mesh", mesh), ("device", device))
          if v is not None}
    return functools.partial(fn, **kw) if kw else fn


def _run_trial(cfg: QBoldConfig, overrides: dict, trial: int,
               run_fn: Callable[[QBoldConfig], dict]) -> dict:
    """One sweep trial in a directory of its own. A trial that raises (the
    NaN tripwire, out of memory, bad hyperparameters) is recorded as
    failed and ranks last; the sweep goes on."""
    overrides = dict(overrides)
    overrides["save_directory"] = f"{cfg.train.save_directory}/trial{trial}"
    run_cfg = apply_flat_overrides(cfg, overrides)
    try:
        out = run_fn(run_cfg)
    except Exception as e:                    # noqa: BLE001 - see docstring
        import sys
        print(f"[sweep] trial {trial} FAILED ({type(e).__name__}: {e}); "
              f"ranking last", file=sys.stderr)
        out = {"status": "failed", "error": f"{type(e).__name__}: {e}"}
    out.update(trial=trial, overrides=overrides)
    return out


def _sort_results(results: list, metric: str, maximize: bool) -> None:
    """Best-first in-place sort: non-finite, missing or non-numeric
    metrics rank LAST (a NaN would break a bare sort's order)."""

    def sort_key(r):
        y = r.get(metric, float("inf"))
        try:
            y = float(y)
        except (TypeError, ValueError):
            return float("inf")
        if not np.isfinite(y):
            return float("inf")
        return -y if maximize else y

    results.sort(key=sort_key)


def random_search(cfg: QBoldConfig, space: dict, n_trials: int,
                  run_fn: Optional[Callable[[QBoldConfig], dict]] = None,
                  metric: str = "val_elbo", seed: int = 0,
                  maximize: bool = False,
                  parallel_trials: int = 1, mesh=None, *,
                  device=None) -> list:
    """Uniform random search over the space grammar (the baseline of the
    Bayesian sweep; wandb parameter dicts too). Results sorted best-first
    on ``metric`` (``maximize`` flips it); failed and non-finite trials
    last. ``parallel_trials > 1``: populations of that size
    (population_pretrain for the default objective, population_full_run
    for ``run_fn=full_run``; other run_fns run serially); ``mesh`` splits
    each population's trials over the ranks."""
    space = _normalise_space(space)
    _check_space_keys(space)
    rng = np.random.default_rng(seed)
    all_ovs = [{k: _draw(rng, spec) for k, spec in space.items()}
               for _ in range(n_trials)]
    pop_fn = _population_fn_for(run_fn, parallel_trials, mesh, device)
    if pop_fn is not None:
        results = []
        for lo in range(0, n_trials, parallel_trials):
            results.extend(
                _population_batch(cfg, all_ovs[lo:lo + parallel_trials],
                                  lo, pop_fn))
        _sort_results(results, metric, maximize)
        return results
    run_fn = _on_device(run_fn or _default_run, device)
    results = [_run_trial(cfg, overrides, trial, run_fn)
               for trial, overrides in enumerate(all_ovs)]
    _sort_results(results, metric, maximize)
    return results


# ---- Tree-structured Parzen Estimator ----------------------------------------------


def _tpe_propose(rng: np.random.Generator, spec: tuple,
                 good: list, bad: list, n_candidates: int):
    """One value for one dimension, maximising the good/bad density ratio
    l(x)/g(x) (Bergstra et al. 2011, 'Algorithms for Hyper-Parameter
    Optimization'); dimensions are modelled independently (TPE's
    factorisation)."""
    kind = spec[0]
    if kind == "fixed":
        return spec[1]

    if kind == "choice":
        choices = spec[1]

        # categorical TPE: smoothed count ratios
        def probs(obs):
            c = np.array([sum(1 for o in obs if o == v) for v in choices],
                         np.float64) + 1.0
            return c / c.sum()
        p_good, p_bad = probs(good), probs(bad)
        score = p_good / p_bad
        # candidates drawn from l, the best-scoring kept
        idx = rng.choice(len(choices), size=n_candidates, p=p_good)
        best = idx[np.argmax(score[idx])]
        return choices[int(best)]

    lo, hi = spec[1], spec[2]
    log = kind == "log_uniform"
    to_x = (lambda v: math.log(v)) if log else (lambda v: v)
    from_x = (lambda x: math.exp(x)) if log else (lambda x: x)
    xlo, xhi = to_x(lo), to_x(hi)
    span = xhi - xlo

    def kde_logpdf(x, obs):
        """Parzen window: one Gaussian per observation plus a uniform
        component over the range (keeps exploration alive)."""
        obs = np.asarray([to_x(o) for o in obs], np.float64)
        bw = max(np.std(obs) if len(obs) > 1 else span, span / 20.0) \
            / max(1.0, len(obs) ** 0.5)
        comp = -0.5 * ((x[:, None] - obs[None, :]) / bw) ** 2 \
            - math.log(bw * math.sqrt(2 * math.pi))
        comp = np.concatenate(
            [comp, np.full((len(x), 1), -math.log(span))], axis=1)
        m = comp.max(axis=1)
        return m + np.log(np.exp(comp - m[:, None]).mean(axis=1))

    # candidates from l: a good observation jittered by its bandwidth
    obs_g = np.asarray([to_x(o) for o in good], np.float64)
    bw_g = max(np.std(obs_g) if len(obs_g) > 1 else span, span / 20.0) \
        / max(1.0, len(obs_g) ** 0.5)
    centers = obs_g[rng.integers(len(obs_g), size=n_candidates)]
    cand = np.clip(centers + rng.normal(size=n_candidates) * bw_g, xlo, xhi)
    score = kde_logpdf(cand, good) - kde_logpdf(cand, bad)
    return from_x(float(cand[int(np.argmax(score))]))


def bayes_search(cfg: QBoldConfig, space: dict, n_trials: int,
                 run_fn: Optional[Callable[[QBoldConfig], dict]] = None,
                 metric: str = "val_elbo", seed: int = 0,
                 gamma: float = 0.25, n_candidates: int = 24,
                 n_startup: int = 5, maximize: bool = False,
                 parallel_trials: int = 1, mesh=None, *,
                 device=None) -> list:
    """Bayesian search (TPE), the counterpart of the reference's wandb
    ``method: bayes`` sweep (configurations/sweep_prior.yaml:2-6). After
    ``n_startup`` random trials each proposal splits the history at the
    ``gamma`` quantile of the objective into good and bad sets and picks,
    per dimension, the candidate maximising the Parzen ratio l(x)/g(x).
    Deterministic given ``seed``; failed and metric-less trials rank last
    and stay out of the model. Returns trials best-first.

    ``parallel_trials > 1``: batch-synchronous TPE -- each round proposes
    that many candidates from the current model and trains them as one
    population (population_pretrain, or population_full_run for
    ``run_fn=full_run``; other run_fns run serially); ``mesh`` splits each
    population's trials over the ranks."""
    space = _normalise_space(space)
    _check_space_keys(space)
    rng = np.random.default_rng(seed)
    results: list[dict] = []
    history: list[tuple[dict, float]] = []   # (overrides, objective)
    pop_fn = _population_fn_for(run_fn, parallel_trials, mesh, device)
    run_fn = _on_device(run_fn or _default_run, device)

    def propose(trial_no: int) -> dict:
        scored = [h for h in history if np.isfinite(h[1])]
        if trial_no < n_startup or len(scored) < 2:
            return {k: _draw(rng, spec) for k, spec in space.items()}
        scored.sort(key=lambda h: h[1])
        n_good = max(1, int(math.ceil(gamma * len(scored))))
        good_h = scored[:n_good]
        bad_h = scored[n_good:] or scored[-1:]
        return {k: _tpe_propose(rng, spec, [h[0][k] for h in good_h],
                                [h[0][k] for h in bad_h], n_candidates)
                for k, spec in space.items()}

    def record(out: dict, overrides: dict) -> None:
        results.append(out)
        y = out.get(metric, float("nan"))
        try:
            y = float(y)
        except (TypeError, ValueError):
            y = float("nan")
        if maximize and np.isfinite(y):
            y = -y
        history.append((overrides, y))

    if pop_fn is not None:
        trial = 0
        while trial < n_trials:
            n_batch = min(parallel_trials, n_trials - trial)
            batch = [propose(trial + j) for j in range(n_batch)]
            for j, out in enumerate(_population_batch(cfg, batch, trial,
                                                      pop_fn)):
                record(out, batch[j])
            trial += n_batch
    else:
        for trial in range(n_trials):
            overrides = propose(trial)
            record(_run_trial(cfg, overrides, trial, run_fn), overrides)

    _sort_results(results, metric, maximize)
    return results
