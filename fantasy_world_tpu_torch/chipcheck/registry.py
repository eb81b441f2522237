"""The card check's phases in the order a whole run takes them, and the
runner that ``chip_smoke.py`` and ``--phases`` share.

Each ``Phase`` names its function, the keys of the run's state it takes
(positionally: ``device``, ``plan`` -- the names of the run's phases -- or
what an earlier phase gave; ``profile_dir``, ``--profile``'s directory or
None, as a keyword) and the keys its return value fills. ``run`` takes
any subset of the phases: each named phase pulls in, before it, the
phases that give what it needs (unless ``FALLBACKS`` makes the key
alone), and after it its ``then`` phases; the run then takes them in
registry order. A key is dropped from
the state after the last phase of the run that needs it, so the card's
memory goes back as a whole run gives it back.
"""
from __future__ import annotations

import dataclasses
import gc
import time

from . import full, jobs, kernels, mesh, serving, small
from .common import say


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    fn: object
    needs: tuple = ()
    gives: tuple = ()
    then: tuple = ()
    # runs mesh ranks (``jobs.World``), which stay open until the run's
    # last such phase has ended
    ranks: bool = False


PHASES = (
    Phase("build", kernels.phase_build),
    Phase("kernels", kernels.phase_kernels, ("device",), ("per_kernel",)),
    Phase("train_kernels", kernels.phase_train_kernels,
          ("device", "per_kernel")),
    Phase("qlinear", kernels.phase_qlinear, ("device",)),
    # the mesh phases' ranks and jobs start here, after the kernels' times,
    # and run beside the reduced phases below
    Phase("meshes_start", mesh.phase_meshes_start, ("device", "plan"),
          ("meshes",), ranks=True),
    Phase("small_slice", small.phase_small_slice, ("device",),
          ("small_cpu",)),
    Phase("small_windowed", small.phase_small_windowed, ("device",)),
    # the reduced clips' card sides; their checks wait for the CPU sides,
    # which run in a process of their own from the start of a whole run
    Phase("small_clip", small.phase_small_clip, ("device",),
          ("small_clip_card",), then=("small_clip_check",)),
    Phase("small_wan22", small.phase_small_wan22, ("device",),
          ("small_wan22_card",), then=("small_wan22_check",)),
    Phase("small_ti2v", small.phase_small_ti2v, ("device",),
          ("small_ti2v_card",), then=("small_ti2v_check",)),
    Phase("small_serve", small.phase_small_serve, ("device",)),
    Phase("small_train", small.phase_small_train, ("device",)),
    Phase("train_cli", small.phase_train_cli),
    Phase("train_cli_data", small.phase_train_cli_data),
    Phase("small_verify", small.phase_small_verify),
    Phase("small_track", small.phase_small_track, ("device",)),
    Phase("small_options", small.phase_small_options, ("device",)),
    # the mesh phases' checks, and the serving mesh: ranks that share the
    # card, before the full model takes it
    Phase("small_meshes", mesh.phase_small_meshes,
          ("device", "small_cpu", "meshes"),
          ("mesh_small", "mesh_serving_small", "mesh_train_small",
           "pipe_train_small", "pipe_seq"), ranks=True),
    Phase("full_mesh", mesh.phase_full_mesh, ("device", "meshes"),
          ("mesh_full", "mesh_train_full", "pipe_train_full"), ranks=True),
    Phase("full_mesh_serving", serving.phase_full_mesh_serving, ("device",),
          ("mesh_serving_full",), ranks=True),
    Phase("wan22_both_resident", serving.phase_wan22_both_resident,
          ("device",), ("both_resident",)),
    Phase("small_clip_check", small.phase_small_clip_check,
          ("small_clip_card",)),
    Phase("small_wan22_check", small.phase_small_wan22_check,
          ("small_wan22_card",)),
    Phase("small_ti2v_check", small.phase_small_ti2v_check,
          ("small_ti2v_card",)),
    # the full width: the Wan2.1 model, then its clip's encoders (CLIP and
    # MoGe go after full_data_train, umT5 and the VAE stay for Wan2.2), the
    # Wan2.2 experts in its place, TI2V-5B beside umT5, the track head
    Phase("full_slice", full.phase_full_slice, ("device", "profile_dir"),
          ("denoise", "per_step", "pipe", "cond", "plucker_fea")),
    Phase("full_verify", full.phase_full_verify, ("device", "pipe"),
          ("verify",)),
    Phase("full_clip", full.phase_full_clip, ("device", "pipe"),
          ("clip_run", "cpipe", "moge")),
    Phase("full_serve", full.phase_full_serve, ("device", "cpipe", "moge"),
          ("serve", None, "t5", "vae")),
    Phase("full_data_train", full.phase_full_data_train, ("device", "cpipe"),
          ("data_train",)),
    Phase("full_train", full.phase_full_train,
          ("device", "pipe", "cond", "plucker_fea", "profile_dir"),
          ("train",)),
    Phase("full_windowed", full.phase_full_windowed,
          ("device", "pipe", "cond", "plucker_fea"), ("windowed",)),
    Phase("full_options", full.phase_full_options,
          ("device", "pipe", "cond", "plucker_fea"), ("options",)),
    Phase("full_wan22", full.phase_full_wan22,
          ("device", "t5", "vae", "profile_dir"), ("wan22", "quant")),
    Phase("full_ti2v", full.phase_full_ti2v, ("device", "t5"), ("ti2v",)),
    Phase("full_track", full.phase_full_track, ("device",), ("track",)),
)
BY_NAME = {p.name: p for p in PHASES}
GIVEN_BY = {key: p.name for p in PHASES for key in p.gives if key}
# what a phase run without its provider takes instead: train_kernels adds
# its numbers to an empty table
FALLBACKS = {"per_kernel": kernels.new_per_kernel}
# the run's own keys: the card, ``--profile``'s directory, the names of
# the run's phases
SEEDED = ("device", "profile_dir", "plan")


def plan(names=None):
    """The phases a run of ``names`` (all when None) takes, in registry
    order: each named phase, the phases that give what it needs (again for
    theirs), and the ``then`` phases of every phase taken."""
    if names is None:
        return list(PHASES)
    unknown = [n for n in names if n not in BY_NAME]
    if unknown:
        raise KeyError(f"no phase {unknown}; the phases: "
                       f"{', '.join(BY_NAME)}")
    take, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name in take:
            continue
        take.add(name)
        phase = BY_NAME[name]
        todo.extend(phase.then)
        todo.extend(GIVEN_BY[k] for k in phase.needs
                    if k not in SEEDED and k not in FALLBACKS)
    return [p for p in PHASES if p.name in take]


def run(device, names=None, profile_dir=None, keep=()):
    """Run the phases of ``plan(names)`` on ``device`` in order; returns
    (the state: what the phases gave and no later phase took, and the
    ``keep`` keys; {phase: wall seconds}). Prints each phase's
    wall seconds as it ends (``[phase_done]``). A whole run first starts the
    reduced clips' CPU sides in a process of their own
    (``small.start_cpu_sides``) and closes it at the end."""
    import torch
    order = plan(names)
    last = {}
    for i, phase in enumerate(order):
        for key in phase.needs:
            last[key] = i
    last_ranks = max((i for i, p in enumerate(order) if p.ranks), default=-1)
    state = {"device": device, "profile_dir": profile_dir,
             "plan": [p.name for p in order]}
    pool = small.start_cpu_sides() if names is None else None
    seconds = {}
    ok = False
    try:
        for i, phase in enumerate(order):
            for key in phase.needs:
                if key not in state:
                    state[key] = FALLBACKS[key]()
            t0 = time.perf_counter()
            out = phase.fn(*(state[k] for k in phase.needs
                             if k != "profile_dir"),
                           **({"profile_dir": profile_dir}
                              if "profile_dir" in phase.needs else {}))
            seconds[phase.name] = time.perf_counter() - t0
            if len(phase.gives) == 1:
                out = (out,)
            for key, value in zip(phase.gives, out or ()):
                if key:
                    state[key] = value
            del out
            for key in [k for k, j in last.items() if j == i]:
                if key not in keep and key not in SEEDED:
                    state.pop(key, None)
            if i == last_ranks:
                jobs.close_worlds()
            gc.collect()
            torch.cuda.empty_cache()
            say("phase_done", name=phase.name,
                seconds=f"{seconds[phase.name]:.1f}")
        ok = True
    finally:
        jobs.close_worlds(abort=not ok)
        if pool is not None:
            if ok:
                pool.close()
            else:
                pool.terminate()
            pool.join()
    return state, seconds
