"""Elastic checkpoint-restart training driver (port of
`repro.runtime.elastic`).

The loop every large-scale trainer runs:

    while budget:
        try:   train until failure (heartbeats checked between steps)
        except/on-failure:
               drop dead workers -> rebuild a smaller mesh from survivors
               -> RESTORE the latest checkpoint onto it -> continue

Failures are simulated (FailureInjector raises at chosen steps and
shrinks the worker set), the path a deployment takes when a process
group reports a lost rank. Mesh shapes degrade along the data axis first.

Two forms. In one process, a worker is a mesh slot, named by its ordinal
in the device list the run was given ("0", "1", ...); the reference names
a worker by its JAX device id. Slots may repeat a card
(`distributed.Mesh`), so two workers on one H100 are two names for one
device (ROADMAP C22). Given a `collectives.World` (SPMD: every rank of a
spawned run calls `run` with the same arguments), a worker is a rank,
named by its ordinal in the run; the mesh is a `RankMesh` over a process
group of the mesh's ranks, and the state is sharded (make_state returns
its shardings as the placement). On a failure every rank leaves the
group; the dropped ranks return, and the survivors form a new group over
themselves (new rank numbers, a new store per generation), make the
state on the smaller mesh and restore the newest checkpoint with its new
shardings.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch._device import visible_devices
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.collectives import World
from repro_torch.distributed.sharding import Mesh, device_array
from repro_torch.runtime.fault import HeartbeatMonitor, StragglerDetector


class WorkerFailure(RuntimeError):
    def __init__(self, workers: Sequence[str]):
        super().__init__(f"workers failed: {list(workers)}")
        self.workers = list(workers)


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples: step -> number
    of workers to drop (the last ones)."""
    schedule: dict[int, int]

    def check(self, step: int, workers: list[str]) -> list[str]:
        drop = self.schedule.get(step, 0)
        if drop and len(workers) > drop:
            raise WorkerFailure(workers[-drop:])
        return workers


def build_mesh_from(devices: Sequence, model_parallel: int,
                    world: World | None = None, tag: str = "mesh"):
    """Largest (data, model) mesh from the surviving devices (slots), or,
    with a World, from the surviving ranks: a RankMesh over a new process
    group of them (its store named by `tag`)."""
    n = len(devices)
    mp = model_parallel
    while mp > 1 and n % mp:
        mp //= 2
    dp = n // mp
    if world is not None:
        return world.join([int(r) for r in devices[:dp * mp]], (dp, mp),
                          ("data", "model"), tag)
    return Mesh(device_array(list(devices[:dp * mp]), (dp, mp)),
                ("data", "model"))


@dataclasses.dataclass
class ElasticTrainer:
    """Wires train_step + checkpoint manager + failure handling together.

    make_state:  (mesh) -> (params, opt_state, step_fn, placement), called
                 on every (re)mesh; step_fn(params, opt_state, batch,
                 mesh) -> (params, opt_state, metrics); placement is where
                 a restore puts the state (a device, a tree of devices, or
                 None for the devices of the fresh state; with a World,
                 the shardings of (params, opt_state), used to save and
                 restore this rank's blocks);
    ckpt:        CheckpointManager;
    save_every:  checkpoint cadence in steps.
    """
    make_state: Callable[[Mesh], tuple[Any, Any, Callable, Any]]
    ckpt: CheckpointManager
    save_every: int = 10
    model_parallel: int = 1
    heartbeat_timeout_s: float = 30.0

    def run(self, batches, num_steps: int,
            injector: FailureInjector | None = None,
            devices: Sequence | None = None,
            world: World | None = None) -> dict:
        """Train `num_steps` steps over the slots `devices` (every visible
        CUDA device when None), or, given `world`, over the ranks of a
        spawned run (`devices` unused). With a world the result also says
        whether this rank was dropped."""
        if world is not None:
            workers = [(str(r), r) for r in range(world.size)]
        else:
            devs = (visible_devices() if devices is None
                    else [torch.device(d) for d in devices])
            workers = [(str(i), d) for i, d in enumerate(devs)]
        monitor = HeartbeatMonitor(timeout_s=self.heartbeat_timeout_s)
        stragglers = StragglerDetector()
        history: list[float] = []
        restarts = 0
        step = 0

        def result(**extra) -> dict:
            return {"losses": history, "restarts": restarts,
                    "final_devices": len(workers),
                    "monitored": monitor.workers(),
                    "stragglers": stragglers.stragglers(), **extra}

        while step < num_steps:
            if world is None:
                mesh = build_mesh_from([d for _, d in workers],
                                       self.model_parallel)
            else:
                mesh = build_mesh_from([r for _, r in workers],
                                       self.model_parallel, world,
                                       tag=f"generation{restarts}")
            params, opt_state, step_fn, placement = self.make_state(mesh)
            # one process: where to restore; SPMD: the state's shardings,
            # which every save and restore of this rank's blocks needs
            spmd = {} if world is None else {"shardings": placement}
            restore_to = spmd or {"device": placement}
            try:
                (params, opt_state), latest = self.ckpt.restore_latest(
                    (params, opt_state), **restore_to)
                step = latest
                # Steps latest..failure-1 are about to re-run; their
                # pre-failure losses would otherwise stay as duplicates
                # (history[i] is step i's loss, appended before step += 1).
                del history[latest:]
            except FileNotFoundError:
                pass
            # Monitor exactly the mesh's workers: heartbeats or step times
            # recorded for a worker OUTSIDE the mesh would keep reporting
            # it as a live (or straggling) worker it no longer is.
            in_mesh = [name for name, _ in workers[:mesh.size]]

            try:
                while step < num_steps:
                    if injector is not None:
                        injector.check(step, [name for name, _ in workers])
                    t0 = time.monotonic()
                    batch = next(batches)
                    params, opt_state, metrics = step_fn(
                        params, opt_state, batch, mesh)
                    dt = time.monotonic() - t0
                    for name in in_mesh:
                        monitor.beat(name)
                        stragglers.record(name, dt)
                    history.append(float(metrics["loss"]))
                    step += 1
                    if step % self.save_every == 0 or step == num_steps:
                        self.ckpt.save_async(step, (params, opt_state),
                                             **spmd)
                self.ckpt.wait()
            except WorkerFailure as wf:
                restarts += 1
                self.ckpt.wait()
                dead = set(wf.workers)
                workers = [(n, d) for n, d in workers if n not in dead]
                # Dead workers leave the monitors too: a restart must not
                # carry their stale heartbeats/step-times into the shrunk
                # mesh's failure or straggler reports.
                for name in dead:
                    monitor.remove(name)
                    stragglers.remove(name)
                if world is not None:
                    world.leave()
                    if str(world.rank) in dead:
                        return result(dropped=True)
                if not workers:
                    raise
                continue

        if world is not None:
            world.leave()
            return result(dropped=False)
        return result()
