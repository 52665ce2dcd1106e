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

:class:`AsyncCheckpointer` writes checkpoints on a background thread, as the
JAX package's does.  Unlike JAX arrays, torch's parameters and optimizer
moments are written in place by the next optimizer step, so the payload is
snapshotted on the caller's thread first (:func:`snapshot`): each tensor is
cloned on its own device, a CUDA tensor on the current (training) stream, with
an event recorded after the clones.  The thread waits on that event from a
stream of its own, copies the clones to the host there, pickles them and
writes the file; the training stream never waits for the host copy.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Callable, Dict, Optional, Union

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


def model_state_dict(model, copy: bool = True) -> Dict[str, Any]:
    """The model's weights and BatchNorm statistics under the reference keys
    (BatchNorm's ``num_batches_tracked`` counters are left out): copies on the
    CPU, or with ``copy=False`` the live tensors themselves, for
    :func:`snapshot`."""
    return {k: v.detach().cpu().clone() if copy else v.detach()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` with ``torch.save`` via a temporary file, so a crash
    never leaves a half-written checkpoint under ``path``."""
    import torch
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _map_tensors(fn, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)``; dicts, lists and
    tuples are rebuilt and numpy arrays copied, other leaves kept."""
    import torch
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class Snapshot:
    """A payload whose tensors are clones taken at one point of the caller's
    streams (:func:`snapshot`); :meth:`to_host` gives it with every tensor on
    the CPU, from any thread."""

    def __init__(self, tree, events):
        self._tree = tree
        self._events = events  # CUDA device -> event recorded after its clones

    def to_host(self):
        import torch
        if not self._events:
            return self._tree
        streams = {}
        for device, event in self._events.items():
            streams[device] = torch.cuda.Stream(device=device)
            streams[device].wait_event(event)

        def fetch(t):
            if t.device.type != "cuda":
                return t
            with torch.cuda.stream(streams[t.device]):
                return t.to("cpu")  # waits for this stream only
        return _map_tensors(fetch, self._tree)


def snapshot(payload) -> Snapshot:
    """Clone every tensor of ``payload`` (detached) on its device, CUDA tensors
    on their current stream, so that later in-place writes (an optimizer
    step) cannot reach the snapshot."""
    import torch
    devices = set()

    def clone(t):
        if t.device.type == "cuda":
            devices.add(t.device)
        return t.detach().clone()
    tree = _map_tensors(clone, payload)
    events = {}
    for device in devices:
        events[device] = torch.cuda.Event()
        events[device].record(torch.cuda.current_stream(device))
    return Snapshot(tree, events)


class AsyncCheckpointer:
    """Background-thread checkpoint writer: the training loop hands over the
    payload and goes on stepping while the device-to-host copy, the pickling
    and the atomic write happen off the step path.

    ``save`` snapshots a dict payload on the caller's thread (see the module
    docstring); a callable payload runs on the writer thread and must itself
    read nothing that the caller goes on changing (return a
    :func:`snapshot`'s ``to_host()``, for one).  At most one save is in
    flight: a new ``save()`` or ``wait()`` first joins the previous one and
    re-raises its error.  ``wait()`` before reading the file back or exiting.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def save(self, path: str,
             payload: Union[Dict[str, Any], Callable[[], Dict[str, Any]]],
             save_fn: Callable[[str, Dict[str, Any]], None] = save_checkpoint) -> None:
        """Queue an atomic checkpoint write of ``payload`` (a dict, or a
        zero-argument callable building one) through ``save_fn``."""
        self.wait()
        build = payload if callable(payload) else snapshot(payload).to_host

        def work():
            try:
                save_fn(path, build())
            except BaseException as e:  # re-raised on the caller's thread
                self._exc = e

        self._thread = threading.Thread(target=work, name="checkpoint-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight (if any) is written; re-raise its
        error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
