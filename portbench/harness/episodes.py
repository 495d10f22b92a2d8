"""Episodes: the same stretch of simulation replayed from one snapshot.

A simulation evolves: left to run on, a faster program would reach the
costlier, raining part of a case within the same seconds and be scored lower
for being fast. So the window replays episodes. Set-up takes a snapshot of
the particulator's state on the device and of both its generators (the host
one that draws each mirror substep's scalars, the device one that draws
rows), and every episode restores it by device copies before it runs the
cell's fixed number of steps through ``Particulator.run``. Every episode
then does the same work.

Each step's time is taken between CUDA events that an observer of the
particulator records on the compute stream after every step, with no
synchronise per step; the host waits for the device once an episode, after
its last step, to read them.
"""

import dataclasses
import time

import torch


def clone_tree(x):
    """a copy of a state tree in which every tensor is a new device copy"""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: clone_tree(getattr(x, f.name))
            for f in dataclasses.fields(x)
        })
    return x


def copy_tree_(dst, src):
    """``src``'s values in ``dst``, a tree of the same layout: each tensor
    copied into its counterpart in place, any other leaf taken from
    ``src``; returns the tree"""
    if isinstance(src, torch.Tensor):
        return dst.copy_(src)
    if isinstance(src, dict):
        return {k: copy_tree_(dst[k], v) for k, v in src.items()}
    if isinstance(src, (list, tuple)):
        return type(src)(copy_tree_(d, v) for d, v in zip(dst, src))
    if dataclasses.is_dataclass(src) and not isinstance(src, type):
        return dataclasses.replace(src, **{
            f.name: copy_tree_(getattr(dst, f.name), getattr(src, f.name))
            for f in dataclasses.fields(src)
        })
    return src


@dataclasses.dataclass
class Snapshot:
    sim_state: dict
    rng_state: torch.Tensor
    device_rng_state: torch.Tensor
    n_steps: int


def snapshot(particulator):
    return Snapshot(
        sim_state=clone_tree(particulator.sim_state),
        rng_state=particulator.rng.get_state(),
        device_rng_state=particulator.device_rng.get_state(),
        n_steps=particulator.n_steps,
    )


def restore(particulator, snap):
    """the particulator as it was at ``snap``: state, generators, step count"""
    particulator.sim_state = None  # the old state's memory is free to reuse
    particulator.sim_state = clone_tree(snap.sim_state)
    particulator.rng.set_state(snap.rng_state)
    particulator.device_rng.set_state(snap.device_rng_state)
    particulator.n_steps = snap.n_steps


class StepClock:
    """an observer that records a CUDA event after every step while armed;
    ``start`` records the event before an episode's first step"""

    def __init__(self, steps):
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        self.k = None

    def start(self):
        self.events[0].record()
        self.k = 1

    def notify(self):
        if self.k is not None:
            self.events[self.k].record()
            self.k += 1

    def stop(self):
        """the steps' times in ms; call after the device has finished"""
        k, self.k = self.k, None
        return [
            self.events[i - 1].elapsed_time(self.events[i]) for i in range(1, k)
        ]


def run_episode(particulator, case, episode):
    """the cell's fixed steps, pausing at ``case.stops`` for ``case.at``"""
    done = 0
    for stop in case.stops:
        particulator.run(stop - done)
        done = stop
        case.at(stop, episode)
    if done < case.episode_steps:
        particulator.run(case.episode_steps - done)


@dataclasses.dataclass
class Window:
    seconds: float
    episode_ms: list  # each episode's steps, summed
    step_ms: list
    failed: int


def run_window(particulator, case, snap, clock, seconds, synchronize):
    """episodes until ``seconds`` have passed on the host clock, each ended
    by ``synchronize()``, a wait for the device; returns the window"""
    step_ms, episode_ms, failed, episode = [], [], 0, 0
    t0 = time.perf_counter()
    while True:
        restore(particulator, snap)
        clock.start()
        run_episode(particulator, case, episode)
        synchronize()
        times = clock.stop()
        if len(times) != case.episode_steps:
            raise RuntimeError(
                f"{len(times)} steps timed in an episode of {case.episode_steps}"
            )
        step_ms.extend(times)
        episode_ms.append(sum(times))
        failed += case.after_episode()
        episode += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return Window(time.perf_counter() - t0, episode_ms, step_ms, failed)
