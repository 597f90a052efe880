"""Model checkpoints of the port: numpy archives beside a JSON sidecar.

Counterpart of kmamiz_tpu/models/checkpoint.py, whose checkpoints are
orbax directories. The port reads and writes its own format with numpy
alone:

    <dir>/step_<N>.npz        one array per params field, named after the
                              field (a None field, e.g. no embedding, is
                              absent); with the optimizer state
                              (save_checkpoint) also "opt_state.count",
                              "opt_state.mu.<field>", "opt_state.nu.<field>";
                              loaded with allow_pickle=False
    <dir>/step_<N>.meta.json  {"step": N, "model": ..., "hidden": ...,
                              "num_features": ..., ...}

The sidecar marks a complete save: it is written last, atomically, and a
step without one is an incomplete save that readers skip. The JAX
package's sidecars carry over unchanged; `params_from_numpy` turns the
JAX package's parameters (as numpy arrays) into the port's. A reader of
params alone (`restore_params`, the forecast route) skips the optimizer
arrays.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from kmamiz_tpu_torch.device import DeviceLike, resolve_device
from kmamiz_tpu_torch.models import gat, graphsage
from kmamiz_tpu_torch.models.common import AdamState
from kmamiz_tpu_torch.models.stlgt import model as stlgt

#: the params NamedTuple of each model module of the port
_PARAMS_TYPES = {
    graphsage: graphsage.SageParams,
    gat: gat.GatParams,
    stlgt: stlgt.StlgtParams,
}
#: name prefix of the optimizer-state arrays in an archive
_OPT = "opt_state."


def params_from_numpy(model, arrays: Mapping[str, np.ndarray], device: DeviceLike = None):
    """`model`'s params (graphsage, gat or stlgt.model) from numpy arrays named
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
    return _save(directory, _arrays(params), step, metadata)


def save_checkpoint(
    directory: str, params, opt_state: AdamState, step: int, metadata: Optional[dict] = None
) -> str:
    """save_params with the optimizer state beside the params, so that a
    resumed run continues the same update sequence; returns the archive's
    path."""
    arrays = _arrays(params)
    arrays[f"{_OPT}count"] = opt_state.count.detach().cpu().numpy()
    for moment in ("mu", "nu"):
        values = getattr(opt_state, moment)
        for field, t in zip(params._fields, values):
            if t is not None:
                arrays[f"{_OPT}{moment}.{field}"] = t.detach().cpu().numpy()
    return _save(directory, arrays, step, metadata)


def _arrays(params) -> dict:
    return {
        f: t.detach().cpu().numpy() for f, t in params._asdict().items() if t is not None
    }


def _save(directory: str, arrays: dict, step: int, metadata: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    # a re-save drops the old sidecar first: a crash mid-re-save must not
    # pair old metadata with a new archive
    if os.path.isfile(f"{path}.meta.json"):
        os.remove(f"{path}.meta.json")
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


def latest_step(directory: str) -> Optional[int]:
    """The newest step with an archive, complete or not."""
    steps = _step_numbers(directory, complete_only=False)
    return max(steps) if steps else None


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


def _read(directory: str, step: Optional[int]):
    """(arrays, meta) of directory/step_<N> (the latest complete step when
    step is None), or None."""
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
    return arrays, meta


def restore_params(
    directory: str, model, step: Optional[int] = None, device: DeviceLike = None
) -> Optional[Tuple[object, dict]]:
    """(params, meta) of `model` from directory/step_<N> (the latest
    complete step when step is None), on `device` (the card when None);
    None when no such checkpoint exists. Optimizer arrays are skipped."""
    read = _read(directory, step)
    if read is None:
        return None
    arrays, meta = read
    params = {k: v for k, v in arrays.items() if not k.startswith(_OPT)}
    return params_from_numpy(model, params, device), meta


def restore_checkpoint(
    directory: str,
    params_template,
    opt_state_template: AdamState,
    step: Optional[int] = None,
) -> Optional[Tuple[object, AdamState, dict]]:
    """(params, opt_state, meta) from directory/step_<N> (the latest
    complete step when step is None), on the templates' device; None when
    no such checkpoint exists. The templates (init_params and the
    optimizer's init of them) give the params type, the fields that are
    None and the device; a shape that differs from the template raises."""
    read = _read(directory, step)
    if read is None:
        return None
    arrays, meta = read
    device = next(t for t in params_template if t is not None).device

    def tensor(name, like):
        if name not in arrays:
            raise ValueError(f"checkpoint {directory} step {meta.get('step')} lacks {name}")
        t = torch.from_numpy(np.array(arrays[name]))
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(
                f"checkpoint {directory}: {name} is {tuple(t.shape)}, the template "
                f"{tuple(like.shape)}"
            )
        return t.to(device=device, dtype=like.dtype)

    fields = params_template._fields
    params = type(params_template)(
        *(None if like is None else tensor(f, like) for f, like in zip(fields, params_template))
    )
    moments = {
        moment: tuple(
            None if like is None else tensor(f"{_OPT}{moment}.{f}", like)
            for f, like in zip(fields, getattr(opt_state_template, moment))
        )
        for moment in ("mu", "nu")
    }
    count = tensor(f"{_OPT}count", opt_state_template.count)
    return params, AdamState(count, moments["mu"], moments["nu"]), meta
