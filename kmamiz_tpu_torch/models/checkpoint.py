"""Model checkpoints of the port: numpy archives beside a JSON sidecar.

Counterpart of kmamiz_tpu/models/checkpoint.py, whose checkpoints are
orbax directories. The port reads and writes its own format with numpy
alone:

    <dir>/step_<N>.npz        one array per params field, named after the
                              field (a None field, e.g. no embedding, is
                              absent); loaded with allow_pickle=False
    <dir>/step_<N>.meta.json  {"step": N, "model": ..., "hidden": ...,
                              "num_features": ..., ...}

The sidecar marks a complete save: it is written last, atomically, and a
step without one is an incomplete save that readers skip. The JAX
package's sidecars carry over unchanged; `params_from_numpy` turns the
JAX package's parameters (as numpy arrays) into the port's.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.models import graphsage
from kmamiz_tpu_torch.models.stlgt import model as stlgt

#: the params NamedTuple of each model module of the port
_PARAMS_TYPES = {graphsage: graphsage.SageParams, stlgt: stlgt.StlgtParams}


def params_from_numpy(model, arrays: Mapping[str, np.ndarray], device: DeviceLike = None):
    """`model`'s params (graphsage or stlgt.model) from numpy arrays named
    after its params fields, as float32 tensors on `device` (the card when
    None). A field absent from `arrays`, or None there, stays None."""
    dev = resolve_device(device)
    if model not in _PARAMS_TYPES:
        raise ValueError(f"no params type for model module {model!r}")
    cls = _PARAMS_TYPES[model]
    unknown = set(arrays) - set(cls._fields)
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(
        **{
            f: (
                None
                if arrays.get(f) is None
                else torch.from_numpy(np.array(arrays[f], dtype=np.float32)).to(dev)
            )
            for f in cls._fields
        }
    )


def save_params(directory: str, params, step: int, metadata: Optional[dict] = None) -> str:
    """Write params under directory/step_<N>.npz and the metadata as the
    step_<N>.meta.json sidecar, each atomically, the sidecar last; returns
    the archive's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    # a re-save drops the old sidecar first: a crash mid-re-save must not
    # pair old metadata with a new archive
    if os.path.isfile(f"{path}.meta.json"):
        os.remove(f"{path}.meta.json")
    arrays = {
        f: t.detach().cpu().numpy()
        for f, t in params._asdict().items()
        if t is not None
    }
    tmp = f"{path}.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, f"{path}.npz")
    tmp = f"{path}.meta.json.tmp"
    with open(tmp, "w") as fh:
        json.dump({"step": step, **(metadata or {})}, fh)
    os.replace(tmp, f"{path}.meta.json")
    return f"{path}.npz"


def _step_numbers(directory: str, complete_only: bool) -> list:
    """Step numbers of step_<N>.npz archives under directory;
    complete_only also requires the sidecar."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not (name.startswith("step_") and name.endswith(".npz")):
            continue
        try:
            step = int(name[len("step_") : -len(".npz")])
        except ValueError:
            continue
        if complete_only and not os.path.isfile(
            os.path.join(directory, f"step_{step}.meta.json")
        ):
            continue
        steps.append(step)
    return steps


def latest_complete_step(directory: str) -> Optional[int]:
    """The newest step whose sidecar exists: an incomplete save is skipped
    in favour of the previous complete one."""
    steps = _step_numbers(directory, complete_only=True)
    return max(steps) if steps else None


def load_metadata(directory: str, step: Optional[int] = None) -> Optional[dict]:
    """The sidecar of directory/step_<N> (the latest complete step when
    step is None); None when no checkpoint or no sidecar exists."""
    if step is None:
        step = latest_complete_step(directory)
        if step is None:
            return None
    meta_path = os.path.join(directory, f"step_{step}.meta.json")
    if not os.path.isfile(meta_path):
        return None
    with open(meta_path) as fh:
        return json.load(fh)


def restore_params(
    directory: str, model, step: Optional[int] = None, device: DeviceLike = None
) -> Optional[Tuple[object, dict]]:
    """(params, meta) of `model` from directory/step_<N> (the latest
    complete step when step is None), on `device` (the card when None);
    None when no such checkpoint exists."""
    if step is None:
        step = latest_complete_step(directory)
        if step is None:
            return None
    path = os.path.join(directory, f"step_{step}")
    if not os.path.isfile(f"{path}.npz"):
        return None
    meta = load_metadata(directory, step) or {"step": step}
    with np.load(f"{path}.npz", allow_pickle=False) as archive:
        arrays = {name: archive[name] for name in archive.files}
    return params_from_numpy(model, arrays, device), meta
