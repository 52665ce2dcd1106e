"""Checkpoints: loading the JAX CLI's pickle files and reference torch ``.bin``
files, and saving the reference ``.bin`` payload.

Both formats carry the reference payload (``epoch``, ``lr``, ``model_pos``,
``model_traj``, ...) with ``model_pos`` already a reference-layout state dict.
The JAX CLI's pickles may also hold its optimizer state as optax objects; the
port has no JAX, so every class outside numpy and the standard containers
unpickles as an opaque placeholder.  Directory (orbax) checkpoints are not read.
The port saves with ``torch.save`` (what the reference writes, and what the JAX
CLI reads); its ``optimizer`` is a ``torch.optim`` state dict, which resumes
training in the port and which the JAX CLI drops.  The port likewise resumes a
JAX CLI checkpoint's optax state with a fresh optimizer
(:func:`is_torch_optimizer_state` tells the two apart).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np

_TRUSTED_MODULES = ("builtins", "collections", "copyreg", "_codecs", "numpy")


class OpaqueObject:
    """Stands in for an object whose class lives outside the port (e.g. optax
    optimizer state in a JAX CLI checkpoint).  Keeps what was pickled."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _TRUSTED_MODULES:
            return super().find_class(module, name)
        return type(name, (OpaqueObject,), {"__module__": module})


def _load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def load_any_checkpoint(path: str) -> Dict[str, Any]:
    """Load a JAX CLI pickle checkpoint or a reference torch ``.bin`` file.

    Returns the payload dict with ``model_pos`` (and ``model_traj``, when
    present) as dicts of numpy arrays in the reference layout.
    """
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path!r} is a directory (orbax) checkpoint, which videopose3d_torch "
            "does not read; convert it to a pickle checkpoint with the JAX CLI")
    try:
        chk = _load_pickle(path)
    except FileNotFoundError:
        raise
    except (pickle.UnpicklingError, EOFError, ValueError, TypeError,
            AttributeError) as e:
        pickle_err = e
    else:
        if isinstance(chk, dict) and "model_pos" in chk:
            return chk
        pickle_err = ValueError("pickle payload has no 'model_pos'")
    import torch
    try:
        chk = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as torch_err:
        raise RuntimeError(
            f"could not load checkpoint {path!r}: not a pickle checkpoint "
            f"({pickle_err!r}) nor a torch .bin ({torch_err!r})") from torch_err
    out = dict(chk)
    for key in ("model_pos", "model_traj"):
        if out.get(key) is not None:
            out[key] = {k: np.asarray(v) for k, v in out[key].items()}
    if not is_torch_optimizer_state(out.get("optimizer")):
        out["optimizer"] = None
    return out


def is_torch_optimizer_state(state) -> bool:
    """Whether ``state`` is a ``torch.optim.Optimizer.state_dict()``."""
    return isinstance(state, dict) and {"state", "param_groups"} <= set(state)


def model_state_dict(model) -> Dict[str, Any]:
    """The model's weights and BatchNorm statistics under the reference keys, on
    the CPU (BatchNorm's ``num_batches_tracked`` counters are left out)."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` with ``torch.save`` via a temporary file, so a crash
    never leaves a half-written checkpoint under ``path``."""
    import torch
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
