"""Fault-tolerant training loop (port of ``repro/train/loop.py``):
restart, elastic re-mesh, stragglers.

* **checkpoint/restart** -- periodic saves (atomic, optionally async);
  on a step failure the loop restores the latest durable checkpoint and
  replays from there (the data pipeline is step-keyed and deterministic,
  so replay is exact), or re-inits at step 0 if there is none;
* **elastic re-mesh** -- at ``remesh_schedule[step]`` the state moves to
  the host, the step is rebuilt for the new mesh and the state is put
  back on its device;
* **straggler count** -- steps that exceed ``step_deadline_s`` are
  counted.

Where the port parts from the reference (``loop.py:130``, which treats
every exception of a step as a node failure): an error that marks a
fault of the program, not of a node -- ``KernelBackwardMissing``, raised
when a kernel without a backward (stencil or bitonic on the card) would
need one -- is re-raised at once.  It raises the same way on
every replay, so restoring would loop forever.  Every other exception
takes the reference's restore path.

Also unlike the reference: the state is the port's TrainState (params
and moments updated in place, ``step`` an int; ``make_train_step``
single-device, so a mesh holds one device); a re-mesh does not init a
throwaway state before putting the old one back; ``LoopConfig.keep``
sets how many checkpoints are kept (the reference keeps
``CheckpointManager``'s default of 3); the step's time ends with its
loss on the host (``float(loss)`` waits for the device) and each one is
reported (``LoopReport.step_s``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import typing

from repro_torch.kernels.ops import KernelBackwardMissing
from repro_torch.models import api
from repro_torch.models.base import ModelConfig
from repro_torch.sharding import umode
from . import optim
from .checkpoint import CheckpointManager
from .data import DataConfig, SyntheticLM, model_batch


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    async_ckpt: bool = True
    step_deadline_s: float = 60.0
    log_every: int = 10
    keep: int = 3


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    final_step: int
    losses: typing.List[float]
    restarts: int
    remesh_events: int
    straggler_steps: int
    final_loss: float
    step_s: typing.List[float] = dataclasses.field(default_factory=list)


def _device(mesh):
    if mesh.size != 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices: the port's train step is "
            f"single-device until LM sharding (ROADMAP §1 item 6)")
    return mesh.devices[0]


def build(cfg: ModelConfig, mesh, opt_cfg: optim.OptConfig, rng=None):
    """(state, step) for (cfg, mesh): the TrainState of params from seed
    ``rng`` (0 by default) on the mesh's device, and
    ``umode.make_train_step``'s step."""
    state = optim.init_state(api.init(0 if rng is None else rng, cfg,
                                      device=_device(mesh)))
    return state, umode.make_train_step(cfg, opt_cfg)


def _to(state, device):
    return optim.tree_map(
        lambda t: t.to(device) if hasattr(t, "to") else t, state)


def run(cfg: ModelConfig, mesh, data_cfg: DataConfig,
        opt_cfg: optim.OptConfig = None, loop_cfg: LoopConfig = None,
        fault_schedule: typing.Dict[int, Exception] = None,
        remesh_schedule: typing.Dict[int, typing.Any] = None,
        verbose: bool = True) -> LoopReport:
    """Run the loop. ``fault_schedule`` injects an exception *before* the
    given step executes (simulating a node failure mid-run);
    ``remesh_schedule`` maps step -> new mesh (elastic shrink/grow)."""
    opt_cfg = opt_cfg or optim.OptConfig(total_steps=loop_cfg.total_steps
                                         if loop_cfg else 100)
    loop_cfg = loop_cfg or LoopConfig()
    fault_schedule = dict(fault_schedule or {})
    remesh_schedule = dict(remesh_schedule or {})
    data = SyntheticLM(data_cfg)
    ckpt = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep,
                             async_save=loop_cfg.async_ckpt)

    device = _device(mesh)
    start = 0
    restored, manifest = ckpt.restore(device=device) \
        if ckpt.latest_step() is not None else (None, None)
    if restored is not None:
        state, step_fn = restored, umode.make_train_step(cfg, opt_cfg)
        start = int(manifest["step"])
        if verbose:
            print(f"[loop] restored from step {start}")
    else:
        state, step_fn = build(cfg, mesh, opt_cfg)

    losses: typing.List[float] = []
    step_s: typing.List[float] = []
    restarts = remesh_events = stragglers = 0
    step = start
    while step < loop_cfg.total_steps:
        if step in remesh_schedule:
            mesh = remesh_schedule.pop(step)
            state_host = _to(state, "cpu")
            del state
            device = _device(mesh)
            step_fn = umode.make_train_step(cfg, opt_cfg)
            state = _to(state_host, device)
            del state_host
            remesh_events += 1
            if verbose:
                print(f"[loop] elastic re-mesh at step {step} -> "
                      f"{dict(mesh.shape)}")
        try:
            if step in fault_schedule:
                raise fault_schedule.pop(step)
            batch = model_batch(cfg, data, step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if dt > loop_cfg.step_deadline_s:
                stragglers += 1
            losses.append(loss)
            step_s.append(dt)
            if verbose and step % loop_cfg.log_every == 0:
                print(f"[loop] step {step} loss {loss:.4f} "
                      f"({dt * 1e3:.1f} ms)")
            step += 1
            if step % loop_cfg.ckpt_every == 0:
                ckpt.save(step, state)
        except KernelBackwardMissing:
            ckpt.wait()
            raise
        except Exception as e:  # noqa: BLE001 — node failure path
            restarts += 1
            if verbose:
                print(f"[loop] step {step} FAILED ({e}); restoring")
            ckpt.wait()
            state = None                    # free the device before restore
            restored, manifest = ckpt.restore(device=device)
            if restored is None:
                state, step_fn = build(cfg, mesh, opt_cfg)
                step = 0
            else:
                state = restored
                step = int(manifest["step"])
    ckpt.wait()
    return LoopReport(steps_run=len(losses), final_step=step, losses=losses,
                      restarts=restarts, remesh_events=remesh_events,
                      straggler_steps=stragglers,
                      final_loss=losses[-1] if losses else float("nan"),
                      step_s=step_s)
