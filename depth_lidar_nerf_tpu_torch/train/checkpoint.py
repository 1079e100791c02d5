"""Checkpoint save and auto-resume (port of ``train/checkpoint.py``).

Role of the reference's ``.tar`` checkpoints + latest-file discovery
(``run_nerf.py:449-477, 1872-1883``): the whole train state is saved every
``i_weights`` iterations and the newest checkpoint of the experiment is
restored on start-up. Where the JAX package saves through orbax, the port
writes one ``torch.save`` file a step, ``<basedir>/<expname>/checkpoints/
<step>.pt``, holding:

- ``step``, the ``TrainState`` step;
- ``models``: each MLP's ``state_dict`` (``fine`` is None without a fine
  pass);
- ``optimizer``: the ``OptaxAdam`` ``state_dict`` (the Adam moments) and
  ``optimizer_count``, its step count, which ``state_dict()`` does not carry
  and the learning-rate schedule and bias corrections read;
- ``discriminator``, ``disc_optimizer`` and ``disc_optimizer_count``: the
  GAN's discriminator and its Adam in the same way (all None without the
  GAN; files of runs without it may lack the keys);
- ``topology``: the config fields that shape the models, checked on load.

A run with the GAN and a checkpoint without a discriminator, or the other
way round, are refused on load, as JAX's orbax restore refuses a template
whose tree differs from the saved one.

A file is written to a temporary name and moved into place with
``os.replace``, so a crash leaves no partial checkpoint; the newest
``KEEP`` (5, orbax's ``max_to_keep``) are kept; "latest" is the highest step,
and a save at or below it is skipped, as orbax's ``should_save`` skips it.
Files are read with ``torch.load(..., weights_only=True)``.

Data parallelism: only rank 0 of a process group writes (:func:`save_state`
returns None elsewhere), and a run's start state is rank 0's
(:func:`broadcast_state`, JAX ``broadcast_one_to_all``): rank 0 restores,
and its state goes to every rank, the GAN's discriminator and its optimizer
included. The other processes need not see the checkpoint directory.

Tensor parallelism (a mesh whose ``tp`` is above 1): a file holds the whole
state in the one-process format. :func:`save_state` gathers each split
parameter and Adam moment over the model group, which every rank enters,
and global rank 0 writes; :func:`broadcast_state` splits the whole state
after it has reached every rank. So a checkpoint of a ``[dp, tp]`` run
resumes in one process, on the fused kernels, or on the same mesh, as
JAX's orbax restore re-shards.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from depth_lidar_nerf_tpu_torch.parallel.distributed import broadcast_object
from depth_lidar_nerf_tpu_torch.parallel.mesh import model_parallel_size
from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
from depth_lidar_nerf_tpu_torch.train.state import (TrainState,
                                                    invalidate_packs,
                                                    shard_train_state)
from depth_lidar_nerf_tpu_torch.weights import gather_mlp_state_dict

FORMAT = "depth_lidar_nerf_tpu_torch.checkpoint.v1"
KEEP = 5
_NAME = re.compile(r"^(\d+)\.pt$")


def ckpt_dir(basedir: str, expname: str) -> str:
    return os.path.abspath(os.path.join(basedir, expname, "checkpoints"))


def topology(cfg: TrainConfig, num_semantic_classes: int) -> Dict:
    """The config fields that decide the models' parameter shapes."""
    return {
        "netdepth": cfg.netdepth, "netwidth": cfg.netwidth,
        "netdepth_fine": cfg.netdepth_fine if cfg.N_importance > 0 else None,
        "netwidth_fine": cfg.netwidth_fine if cfg.N_importance > 0 else None,
        "use_viewdirs": cfg.use_viewdirs,
        "multires": cfg.multires if cfg.i_embed != -1 else 0,
        "multires_views": (cfg.multires_views
                           if cfg.i_embed != -1 and cfg.use_viewdirs else 0),
        "num_semantic_classes": num_semantic_classes,
    }


def steps(directory: str):
    """Steps of the checkpoints in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    found = steps(directory)
    return found[-1] if found else None


def path_of(directory: str, step: int) -> str:
    return os.path.join(directory, f"{step}.pt")


def save_state(directory: str, state: TrainState, step: int, topo: Dict,
               keep: int = KEEP, mesh=None) -> Optional[Tuple[str, int]]:
    """Write ``state`` as ``<directory>/<step>.pt`` and drop all but the
    newest ``keep``; returns the path and its size in bytes, or None when
    ``step`` is not above the latest checkpoint's or this process is not
    rank 0 of a process group (nothing written). The file holds
    ``state.step``, which equals ``step`` except where JAX's final save
    labels a state by ``N_iters``. On a ``mesh`` with a model axis every
    rank calls it (:func:`full_payload` is a collective)."""
    payload = full_payload(state, topo, mesh)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    last = latest_step(directory)
    if last is not None and step <= last:
        return None
    os.makedirs(directory, exist_ok=True)
    path = path_of(directory, step)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in steps(directory)[:-keep]:
        os.remove(path_of(directory, old))
    return path, os.path.getsize(path)


def state_payload(state: TrainState, topo: Dict) -> Dict:
    """What a checkpoint file holds (the module's note)."""
    payload = {
        "format": FORMAT,
        "step": int(state.step),
        "topology": topo,
        "models": {"coarse": state.models.coarse.state_dict(),
                   "fine": (None if state.models.fine is None
                            else state.models.fine.state_dict())},
        "optimizer": state.optimizer.state_dict(),
        "optimizer_count": int(state.optimizer.count),
        "discriminator": None, "disc_optimizer": None,
        "disc_optimizer_count": None,
    }
    if state.models.discriminator is not None:
        payload.update(
            discriminator=state.models.discriminator.state_dict(),
            disc_optimizer=state.disc_optimizer.state_dict(),
            disc_optimizer_count=int(state.disc_optimizer.count))
    return payload


def full_payload(state: TrainState, topo: Dict, mesh=None) -> Dict:
    """:func:`state_payload` of the whole state: on a ``mesh`` with a model
    axis, the MLPs' split parameters and Adam moments gathered over the
    model group (every rank of it calls this), the file of one process.
    Else :func:`state_payload` as it is."""
    payload = state_payload(state, topo)
    if model_parallel_size(mesh) <= 1:
        return payload
    nets = [(k, m) for k, m in (("coarse", state.models.coarse),
                                ("fine", state.models.fine)) if m is not None]
    names = [(k, name) for k, m in nets for name, _ in m.named_parameters()]
    moments = payload["optimizer"]["state"]
    parts = [None] * mesh.tp
    dist.all_gather_object(parts, _to_cpu(
        {"models": payload["models"], "moments": moments}),
        group=mesh.model_group)
    models = dict(nets)
    for k, m in nets:
        if hasattr(m, "full_shapes"):
            payload["models"][k] = gather_mlp_state_dict(
                [p["models"][k] for p in parts], m.full_shapes)
    for i, (k, name) in enumerate(names):
        if i in moments and hasattr(models[k], "full_shapes"):
            shape = models[k].full_shapes[name]
            moments[i] = gather_mlp_state_dict(
                [p["moments"][i] for p in parts],
                dict.fromkeys(moments[i], shape))
    return payload


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def broadcast_state(state: TrainState, topo: Dict, mesh) -> TrainState:
    """Global rank 0's state (models, optimizers, step; whole MLPs) on every
    rank of ``mesh``: rank 0's :func:`state_payload` is broadcast and
    restored elsewhere; then, on a mesh with a model axis, each rank keeps
    its part (:func:`train.state.shard_train_state`). Without a mesh,
    ``state`` as it is."""
    if mesh is None:
        return state
    rank0 = mesh.global_rank == 0
    payload = _to_cpu(state_payload(state, topo)) if rank0 else None
    payload = broadcast_object(payload, mesh)
    if not rank0:
        restore(payload, state, topo, source="rank 0's state")
    return shard_train_state(state, mesh)


def load_file(path: str) -> Dict:
    """A checkpoint file's contents on the CPU. ``weights_only=True``: a
    file that needs arbitrary unpickling is refused, never retried."""
    return torch.load(path, map_location="cpu", weights_only=True)


def check_topology(saved: Dict, topo: Dict, source: str) -> None:
    """Refuse a checkpoint whose ``topology`` differs from ``topo`` in any of
    ``topo``'s fields."""
    diff = {k: (saved.get(k), v) for k, v in topo.items() if saved.get(k) != v}
    if diff:
        raise ValueError(
            f"{source} was trained with another model topology "
            + ", ".join(f"{k}={a} (this run: {b})" for k, (a, b) in diff.items())
            + " — check the netdepth/netwidth/multires/use_viewdirs flags "
            "match the checkpoint's training config")


def restore(ckpt: Dict, state: TrainState, topo: Dict,
            source: str = "checkpoint") -> TrainState:
    """Load a checkpoint (the dict of :func:`load_file`) into ``state``: the
    models, the optimizer's moments and count, the step, and with the GAN
    the discriminator and its optimizer."""
    if ckpt.get("format") != FORMAT:
        raise ValueError(
            f"{source} is neither a checkpoint of this package (format "
            f"{FORMAT!r}) nor a reference .tar (network_fn_state_dict)")
    check_topology(ckpt["topology"], topo, source)
    models = state.models
    if (models.fine is None) != (ckpt["models"]["fine"] is None):
        raise ValueError(f"{source}: the fine MLP is present in only one of "
                         "the checkpoint and this run (N_importance)")
    disc = models.discriminator
    if (disc is None) != (ckpt.get("discriminator") is None):
        raise ValueError(
            f"{source}: the GAN's discriminator is present in only one of the "
            "checkpoint and this run (gan_loss); JAX's restore refuses such a "
            "checkpoint too. Start the run afresh (--no_reload) or fine-tune "
            "from a reference .tar (--ft_path)")
    models.coarse.load_state_dict(ckpt["models"]["coarse"])
    if models.fine is not None:
        models.fine.load_state_dict(ckpt["models"]["fine"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.optimizer.count = int(ckpt["optimizer_count"])
    if disc is not None:
        disc.load_state_dict(ckpt["discriminator"])
        state.disc_optimizer.load_state_dict(ckpt["disc_optimizer"])
        state.disc_optimizer.count = int(ckpt["disc_optimizer_count"])
    state.step = int(ckpt["step"])
    invalidate_packs(models)
    return state
