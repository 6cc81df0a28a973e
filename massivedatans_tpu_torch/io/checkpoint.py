"""Checkpoint / resume of the batched sampler state.

Counterpart of ``massivedatans_tpu/io/checkpoint.py``, with the same
layout and names: ``<dir>/state.npz`` (the engine state and the random
generator), ``<dir>/host.npz`` (host context of the integrator),
``<dir>/chunk_NNNNN.npz`` (the dead-point stream, one file per chunk) and
``<dir>/meta.json``. Every write goes to a temporary file that
``os.replace`` then puts in place. ``state.npz`` is the commit: it holds
the host context and the meta too, and the loaders read them from there,
so one ``os.replace`` moves the whole checkpoint from one chunk to the
next and a run killed between two writes resumes a consistent checkpoint.
``host.npz`` and ``meta.json`` are copies for a reader, written after it;
chunk files are written before it, and those past its ``chunk_index``
are ignored.

The format is this package's own, tagged ``format`` =
``"massivedatans_tpu_torch"`` with ``FORMAT_VERSION``:

- each ``EngineState`` field is stored under its dataclass name (the
  nested ``Shelves`` as ``shelves.<field>``), in its own dtype, so a
  field added or reordered cannot silently land in another's place; the
  host int ``n_groups`` goes to the meta;
- of the point pile only the used prefix (``pile_size`` rows) is stored;
  loading pads it back to the template's ``[P + 1, ndim]`` with zeros,
  which is what the run holds there (rows at or past ``pile_size`` are
  written before they are read, and row ``P`` is a write sink);
- the ``torch.Generator`` that drives the run is stored beside the state
  (``get_state()``, with its device type): the JAX package keeps its key
  inside the state, the port passes the generator beside it;
- the integrator's host context holds, beside the running mask, the pile
  compaction predictor (``prev_pile_size``, ``growth_est``, as the JAX
  package's) and the fill rates the chunk program plans its blocks from
  (``block_rates``, NaN before the first chunk), so that a resumed run
  compacts and replays as the uninterrupted one (version 2; version 1
  lacked both).

A JAX package checkpoint (state stored by position, no format tag), a
checkpoint of another format version, and a checkpoint whose shapes or
dtypes differ from this run's (another nlive or ndata, say) are refused
with a ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from massivedatans_tpu_torch.ns.engine import EngineState
from massivedatans_tpu_torch.ns.shelves import Shelves

FORMAT = "massivedatans_tpu_torch"
FORMAT_VERSION = 2

_STATE = "state.npz"
_HOST = "host.npz"
_META = "meta.json"
_PILE = ("pile_u", "pile_x")


def _tensor_fields(state: EngineState):
    """``(name, tensor)`` for every tensor of the state, ``Shelves``
    flattened to ``shelves.<field>``."""
    for f in dataclasses.fields(EngineState):
        value = getattr(state, f.name)
        if isinstance(value, Shelves):
            for g in dataclasses.fields(Shelves):
                yield f"shelves.{g.name}", getattr(value, g.name)
        elif f.name != "n_groups":  # a host int, kept in meta.json
            yield f.name, value


def _savez(path: str, name: str, arrays: dict):
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name[:-len(".npz")] + ".tmp.npz")
    np.savez(tmp, **arrays)  # np.savez appends .npz to other suffixes
    os.replace(tmp, os.path.join(path, name))


def save_state(path: str, state: EngineState, generator: torch.Generator,
               host_ctx: dict, meta: dict):
    """Write the state, the generator, ``host_ctx`` (numpy arrays) and
    ``meta`` (JSON values; ``n_groups`` is added) in one ``state.npz``,
    then their copies ``host.npz`` and ``meta.json``."""
    n = int(state.pile_size)
    meta = dict(meta, format=FORMAT, n_groups=int(state.n_groups))
    arrays = {"format": np.array(FORMAT),
              "format_version": np.int64(FORMAT_VERSION),
              "generator.state": generator.get_state().numpy(),
              "generator.device": np.array(generator.device.type),
              "meta": np.array(json.dumps(meta))}
    arrays.update({f"host.{k}": v for k, v in host_ctx.items()})
    for name, t in _tensor_fields(state):
        arrays[name] = (t[:n] if name in _PILE else t).cpu().numpy()
    _savez(path, _STATE, arrays)
    _savez(path, _HOST, host_ctx)
    tmp = os.path.join(path, _META + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, os.path.join(path, _META))


def save_chunk(path: str, chunk_index: int, arrays: dict):
    _savez(path, f"chunk_{chunk_index:05d}.npz", arrays)


def _check_format(path: str, data) -> None:
    if "format" not in data:
        raise ValueError(
            f"checkpoint {path} has no format tag: it was written by the JAX "
            "package (massivedatans_tpu), which stores the state by position "
            f"and its random key inside it; {FORMAT} cannot resume it. "
            "Finish the run with the JAX package or restart without the "
            "checkpoint")
    found = (str(data["format"]), int(data["format_version"]))
    if found != (FORMAT, FORMAT_VERSION):
        raise ValueError(
            f"checkpoint {path} has state format {found[0]} v{found[1]}, "
            f"this build expects {FORMAT} v{FORMAT_VERSION}; finish the run "
            "with the matching code version or restart without the checkpoint")


def load_state(path: str, template: EngineState,
               generator: torch.Generator) -> EngineState:
    """Rebuild the state saved in ``path`` on the template's device, with
    the template's shapes and dtypes, and set ``generator`` to the saved
    generator state."""
    with np.load(os.path.join(path, _STATE), allow_pickle=False) as npz:
        data = dict(npz)
    _check_format(path, data)
    saved_device = str(data["generator.device"])
    if saved_device != generator.device.type:
        raise ValueError(
            f"checkpoint {path} was written with a {saved_device} generator "
            f"and this run's generator is on {generator.device.type}: their "
            "random states do not interchange (Philox on cuda, mt19937 on "
            "cpu), so the run would silently differ. Resume on the device "
            "that wrote the checkpoint")
    values = {}
    for name, t in _tensor_fields(template):
        if name not in data:
            raise ValueError(f"checkpoint {path} lacks the state field {name}")
        arr = data[name]
        want = tuple(t.shape)
        if name in _PILE and arr.ndim == 2 and arr.shape[0] < want[0] \
                and arr.shape[1:] == want[1:]:
            arr = np.concatenate(
                [arr, np.zeros((want[0] - arr.shape[0],) + want[1:], arr.dtype)])
        if arr.shape != want or torch.from_numpy(arr).dtype != t.dtype:
            raise ValueError(
                f"checkpoint {path} holds {name} as {arr.dtype}{list(arr.shape)} "
                f"but this run expects {t.dtype}{list(want)}: it was written "
                "with other run parameters (nlive, ndata, pile capacity, "
                "phantom or shelf capacity); resume with the original "
                "settings or restart without the checkpoint")
        values[name] = torch.from_numpy(arr).to(t.device)
    shelves = Shelves(**{g.name: values.pop(f"shelves.{g.name}")
                         for g in dataclasses.fields(Shelves)})
    generator.set_state(torch.from_numpy(data["generator.state"]))
    return EngineState(**values, shelves=shelves,
                       n_groups=int(json.loads(str(data["meta"]))["n_groups"]))


def load_host(path: str) -> dict:
    """The host context committed with the state (``host.npz`` is its
    copy)."""
    with np.load(os.path.join(path, _STATE), allow_pickle=False) as npz:
        _check_format(path, npz)
        return {k[len("host."):]: npz[k] for k in npz.files
                if k.startswith("host.")}


def load_meta(path: str) -> dict:
    """The meta committed with the state (``meta.json`` is its copy)."""
    with np.load(os.path.join(path, _STATE), allow_pickle=False) as npz:
        _check_format(path, npz)
        return json.loads(str(npz["meta"]))


def load_chunks(path: str):
    names = sorted(n for n in os.listdir(path)
                   if n.startswith("chunk_") and n.endswith(".npz")
                   and ".tmp" not in n)
    out = []
    for n in names:
        with np.load(os.path.join(path, n), allow_pickle=False) as npz:
            out.append(dict(npz))
    return out


def has_checkpoint(path) -> bool:
    return path is not None and os.path.exists(os.path.join(path, _STATE))
