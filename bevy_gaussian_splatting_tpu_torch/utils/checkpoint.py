"""Training checkpoints: a cloud, its Adam state and metadata in one npz
file, in the JAX package's layout (``utils/checkpoint.py``), so that a
checkpoint moves both ways between the packages.

Keys:
  ``__cloud_format__``  ["3d"] or ["4d"]
  ``__step__``          [step]
  ``cloud/<field>``     each field of the cloud, float32
  ``opt/0``             Adam's update count, int32 scalar (optax's ``count``)
  ``opt/1`` .. ``opt/F``       first moments (optax ``mu``), in the cloud's
                               field order
  ``opt/F+1`` .. ``opt/2F``    second moments (optax ``nu``), same order
  ``extra/<key>``       anything else the caller stores

These are the leaves of ``optax.adam(lr).init(cloud)`` flattened, so JAX's
``load_checkpoint(path, optax.adam(lr).init(cloud))`` reads a checkpoint of
the port, and the port resumes a JAX run into ``torch.optim.Adam``'s
``step``, ``exp_avg`` and ``exp_avg_sq`` (``train/step.py`` ``adam`` is
optax.adam's update).  Only Adam without amsgrad is written: other
optimizers have state that the JAX side cannot read.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian4dCloud, cloud_class
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud


def _check_adam(optimizer) -> None:
    if type(optimizer) is not torch.optim.Adam:
        raise TypeError(f"checkpoints carry Adam's state only (optax.adam's leaves), not {type(optimizer).__name__}")
    if any(group.get("amsgrad") for group in optimizer.param_groups):
        raise TypeError("an amsgrad Adam has a third moment that optax.adam's state does not hold")


def _params(model: TrainableCloud, optimizer) -> list:
    params = [getattr(model, name) for name in model.fields]
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    missing = [name for name, p in zip(model.fields, params) if id(p) not in owned]
    if missing:
        raise ValueError(f"the optimizer does not hold the model's parameters {missing}")
    return params


def save_checkpoint(path: str, cloud_or_model, optimizer=None, step: int = 0, extra: Optional[dict] = None) -> None:
    """Write a cloud (or a :class:`TrainableCloud`'s parameters) and, with
    ``optimizer`` (a ``torch.optim.Adam`` over the model), its state."""
    model = cloud_or_model if isinstance(cloud_or_model, TrainableCloud) else None
    cloud = model.cloud() if model is not None else cloud_or_model
    arrays = {
        "__cloud_format__": np.array(["4d" if isinstance(cloud, Gaussian4dCloud) else "3d"]),
        "__step__": np.array([step]),
    }
    for f in dataclasses.fields(cloud):
        arrays[f"cloud/{f.name}"] = getattr(cloud, f.name).detach().to(torch.float32).cpu().numpy()
    if optimizer is not None:
        if model is None:
            raise ValueError("optimizer state needs the TrainableCloud it optimises")
        _check_adam(optimizer)
        params = _params(model, optimizer)
        states = [optimizer.state.get(p, {}) for p in params]
        counts = {int(s["step"]) if s else 0 for s in states}
        if len(counts) != 1:
            raise ValueError(f"the parameters took different numbers of steps {sorted(counts)}")
        arrays["opt/0"] = np.array(counts.pop(), dtype=np.int32)
        for k, key in enumerate(("exp_avg", "exp_avg_sq")):
            for i, (p, s) in enumerate(zip(params, states)):
                moment = s[key].detach() if s else torch.zeros_like(p)
                arrays[f"opt/{1 + k * len(params) + i}"] = moment.to(torch.float32).cpu().numpy()
    for k, v in (extra or {}).items():
        arrays[f"extra/{k}"] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_checkpoint(path: str, model: Optional[TrainableCloud] = None, optimizer=None, device: DeviceLike = None):
    """Read a checkpoint of either package -> ``(cloud, optimizer or None,
    step, extra)``.

    The cloud lands on ``device`` (the model's device when a ``model`` is
    given, else the card unless ``device="cpu"``); its class follows the
    field names.  With ``model``, the parameters take the cloud's values in
    place; with ``optimizer`` too (a ``torch.optim.Adam`` over ``model``),
    Adam's ``step``, ``exp_avg`` and ``exp_avg_sq`` take the checkpoint's."""
    with np.load(path, allow_pickle=False) as z:
        step = int(z["__step__"][0])
        fields = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("cloud/")}
        extra = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("extra/")}
        opt_leaves = {k: z[k] for k in z.files if k.startswith("opt/")}
    cls = cloud_class(fields)
    names = [f.name for f in dataclasses.fields(cls)]
    dev = next(model.parameters()).device if model is not None else resolve_device(device)
    cloud = cls(**{name: torch.from_numpy(np.asarray(fields[name], np.float32)).to(dev) for name in names})
    if model is not None:
        if model.cloud_class is not cls or any(
                getattr(model, name).shape != getattr(cloud, name).shape for name in names):
            raise ValueError(f"the checkpoint holds a {cls.__name__} of {len(cloud)} rows, the model another cloud")
        with torch.no_grad():
            for name in names:
                getattr(model, name).copy_(getattr(cloud, name))
    if optimizer is not None:
        if model is None:
            raise ValueError("optimizer state needs the TrainableCloud it optimises")
        _check_adam(optimizer)
        params = _params(model, optimizer)
        if len(opt_leaves) != 1 + 2 * len(params):
            raise ValueError(f"the checkpoint holds {len(opt_leaves)} optimizer leaves, Adam over "
                             f"{len(params)} fields needs {1 + 2 * len(params)}")
        count = float(opt_leaves["opt/0"])
        for i, p in enumerate(params):
            group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
            on_device = group.get("capturable") or group.get("fused")
            optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32, device=p.device if on_device else "cpu"),
                "exp_avg": torch.from_numpy(opt_leaves[f"opt/{1 + i}"]).to(p.device, torch.float32),
                "exp_avg_sq": torch.from_numpy(opt_leaves[f"opt/{1 + len(params) + i}"]).to(p.device, torch.float32),
            }
    return cloud, optimizer, step, extra
