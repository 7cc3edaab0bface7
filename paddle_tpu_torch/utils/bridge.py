"""Weights and optimizer state across from and back to the JAX package,
as numpy arrays: :func:`load_jax_params` fills a port model's parameters
from JAX variables and :func:`export_jax_params` writes them back by JAX
path; :func:`load_jax_opt_state` fills the port's optimizer state (Adam's
``St(m, v)``, momentum's velocity, ``chain``'s tuples) and step from a
JAX run's, so the run continues in the port, and
:func:`export_jax_opt_state` gives the JAX form back.
:func:`checkpoint_tree` gives a whole port ``TrainState`` in the form of
the JAX ``TrainState.as_dict()``, which is what a checkpoint holds, and
:func:`load_checkpoint_tree` loads such a tree back into one.

Two forms are taken:

- the nested ``{"params": {"<model name>": {...}}, "state": {...}}`` dict
  that the JAX model's ``init`` returns;
- the flat dict of ``"::"``-joined paths that the JAX package's
  ``save_variables_npz`` writes (``np.load`` of that file gives it).

The ``"params"`` collection fills the model's parameters and the
``"state"`` collection (BatchNorm's running ``mean`` and ``var``) its
buffers, by the same path names.

Paths map to parameter names mechanically: ``block{i}/...`` is
``blocks.{i}...`` and the rest of the path is kept, so ``block0/attn/wq``
fills ``blocks.0.attn.wq``, and back. Layouts already agree
(``Linear.w`` is ``[in, out]`` on both sides), so nothing is transposed.

Parameters made by the JAX package under ``bfloat16_compute`` are f32
(the policy keeps parameters in f32 and casts only compute), so they load
as they are under either policy.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["checkpoint_tree", "export_jax_opt_state", "export_jax_params",
           "jax_root", "load_checkpoint_tree", "load_jax_opt_state",
           "load_jax_params"]

_SEP = "::"     # the npz key separator of save_variables_npz
_BLOCK = re.compile(r"^block(\d+)$")
_ROOT = "transformer_lm"    # the JAX TransformerLM's default name


def _flatten(variables: Mapping[str, Any]
                       ) -> Dict[Tuple[str, ...], np.ndarray]:
    """``{path tuple: array}`` for every leaf, from either form."""
    flat: Dict[Tuple[str, ...], np.ndarray] = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (str(k),))
            else:
                flat[prefix + (str(k),)] = np.asarray(v)

    if variables and all(_SEP in k for k in variables):
        for k, v in variables.items():
            flat[tuple(k.split(_SEP))] = np.asarray(v)
    else:
        walk(variables, ())
    return flat


def _torch_name(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path:
        m = _BLOCK.match(p)
        parts.extend(["blocks", m.group(1)] if m else [p])
    return ".".join(parts)


def _jax_path(name: str) -> Tuple[str, ...]:
    """The inverse of :func:`_torch_name`: ``blocks.0.attn.wq`` is
    ``("block0", "attn", "wq")``."""
    parts, out = name.split("."), []
    i = 0
    while i < len(parts):
        if parts[i] == "blocks" and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            out.append(f"block{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out)


def _by_name(tree: Mapping[str, Any], what: str) -> Dict[str, np.ndarray]:
    """A params-shaped JAX tree ``{root: {...}}`` as ``{torch name:
    array}``."""
    flat = _flatten(tree)
    roots = {p[0] for p in flat}
    if len(roots) != 1:
        raise ValueError(f"{what}: expected one model root, got "
                         f"{sorted(roots)}")
    return {_torch_name(p[1:]): a for p, a in flat.items()}


def _nest(named: Mapping[str, torch.Tensor], root: str) -> Dict[str, Any]:
    """``{torch name: tensor}`` as the JAX tree ``{root: {...}}`` of
    numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, t in named.items():
        node = tree.setdefault(root, {})
        *head, leaf = _jax_path(name)
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = _host(t)
    return tree


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; a copy on the CPU too, since the optimizer
    updates its tensors in place."""
    return t.detach().to("cpu", copy=True).numpy()


def jax_root(model: torch.nn.Module) -> str:
    """The JAX model's name, the root of its variable trees: the model's
    ``JAX_ROOT`` where it has one (``TransformerLM``: ``transformer_lm``),
    else the JAX default ``<ClassName>_0`` (``ResNetCifar_0``)."""
    return getattr(model, "JAX_ROOT", f"{type(model).__name__}_0")


def _fill(what: str, targets: Dict[str, torch.Tensor],
          incoming: Dict[str, np.ndarray]) -> None:
    """Copy ``incoming`` into ``targets`` by name; raises on a missing,
    extra or mis-shaped array before copying any."""
    missing = sorted(set(targets) - set(incoming))
    extra = sorted(set(incoming) - set(targets))
    if missing or extra:
        raise ValueError(f"{what} mismatch: missing {missing}, "
                         f"extra {extra}")
    for name, t in targets.items():
        a = incoming[name]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: JAX shape {tuple(a.shape)} != "
                             f"{tuple(t.shape)}")
    with torch.no_grad():
        for name, t in targets.items():
            t.copy_(torch.from_numpy(np.array(incoming[name])))


def load_jax_params(model: torch.nn.Module,
                    variables: Mapping[str, Any]) -> torch.nn.Module:
    """Copy the JAX variables into ``model``: the ``"params"`` collection
    into its parameters and the ``"state"`` collection into its buffers,
    by path name. Raises on a missing, extra or mis-shaped array, or on
    another collection. Returns ``model``."""
    flat = _flatten(variables)
    extra_cols = {p for p in flat if p[0] not in ("params", "state")}
    if extra_cols:
        raise ValueError(f"only the 'params' and 'state' collections are "
                         f"ported; got "
                         f"{sorted(_SEP.join(p) for p in extra_cols)}")
    short = sorted(_SEP.join(p) for p in flat if len(p) < 3)
    if short:
        raise ValueError(f"variables {short} are not under 'params::<root>' "
                         f"or 'state::<root>'")
    roots = {p[1] for p in flat}
    if len(roots) != 1:
        raise ValueError(f"expected one model root, got {sorted(roots)}")
    incoming = {col: {_torch_name(p[2:]): a for p, a in flat.items()
                      if p[0] == col} for col in ("params", "state")}
    _fill("parameter", dict(model.named_parameters()), incoming["params"])
    _fill("state", dict(model.named_buffers()), incoming["state"])
    return model


def export_jax_params(model: torch.nn.Module,
                      root: str = _ROOT) -> Dict[str, np.ndarray]:
    """``model``'s parameters and buffers as the flat ``"::"``-joined dict
    that ``save_variables_npz`` writes (``"params::transformer_lm::block0::
    attn::wq"``, ``"state::ResNet_0::stem::bn::mean"``), numpy arrays
    copied off the device. ``root`` is the JAX model's name."""
    out = {}
    for col, named in (("params", model.named_parameters()),
                       ("state", model.named_buffers())):
        for n, t in named:
            out[_SEP.join((col, root) + _jax_path(n))] = _host(t)
    return out


def _load_state(port: Any, jax_state: Any, where: str) -> None:
    if isinstance(port, dict):
        if not isinstance(jax_state, Mapping):
            raise ValueError(f"{where}: expected a params-shaped tree, got "
                             f"{type(jax_state).__name__}")
        incoming = _by_name(jax_state, where)
        if set(incoming) != set(port):
            raise ValueError(f"{where}: missing "
                             f"{sorted(set(port) - set(incoming))}, extra "
                             f"{sorted(set(incoming) - set(port))}")
        for name, t in port.items():
            a = incoming[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{where}/{name}: JAX shape "
                                 f"{tuple(a.shape)} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a)))
    elif isinstance(port, tuple):
        if not isinstance(jax_state, tuple) or len(jax_state) != len(port):
            raise ValueError(f"{where}: structure differs from the port's "
                             f"{type(port).__name__} of {len(port)}")
        for i, (p, j) in enumerate(zip(port, jax_state)):
            _load_state(p, j, f"{where}[{i}]")
    elif isinstance(port, torch.Tensor):
        a = np.asarray(jax_state)
        if tuple(a.shape) != tuple(port.shape):
            raise ValueError(f"{where}: JAX shape {tuple(a.shape)} != "
                             f"{tuple(port.shape)}")
        port.copy_(torch.from_numpy(np.array(a)))
    else:
        raise TypeError(f"{where}: unknown optimizer state leaf "
                        f"{type(port).__name__}")


@torch.no_grad()
def load_jax_opt_state(train_state, opt_state: Any, step: Any):
    """Copy a JAX optimizer state (the JAX ``TrainState.opt_state``: a
    NamedTuple such as Adam's ``St(m, v)``, tuples from ``chain``,
    params-shaped trees as leaves) into ``train_state.opt_state`` of the
    port's :class:`~paddle_tpu_torch.train.TrainState` in place, by
    structure and parameter path, and set its step. Raises where the
    structures, names or shapes differ. Returns ``train_state``."""
    _load_state(train_state.opt_state, opt_state, "opt_state")
    train_state.step = int(np.asarray(step))
    return train_state


def export_jax_opt_state(opt_state: Any, root: str = _ROOT) -> Any:
    """The port's optimizer state in the JAX form: the same tuples and
    NamedTuples, each params-shaped dict as ``{root: {...}}`` of numpy
    arrays."""
    if isinstance(opt_state, dict):
        return _nest(opt_state, root)
    if isinstance(opt_state, tuple):
        parts = [export_jax_opt_state(s, root) for s in opt_state]
        return type(opt_state)(*parts) if hasattr(opt_state, "_fields") \
            else tuple(parts)
    if isinstance(opt_state, torch.Tensor):
        return _host(opt_state)
    raise TypeError(f"unknown optimizer state leaf "
                    f"{type(opt_state).__name__}")


def checkpoint_tree(train_state, root: str = _ROOT) -> Dict[str, Any]:
    """The port's :class:`~paddle_tpu_torch.train.TrainState` as the JAX
    ``TrainState.as_dict()`` of host numpy arrays: ``params`` and
    ``state`` nested under the model's root name ``root``
    (:func:`jax_root`), ``opt_state`` as :func:`export_jax_opt_state`
    gives it (the JAX tuples and NamedTuples, so that the JAX
    ``Trainer.restore`` grafts its leaves in the same order) and ``step``
    a 0-d int32 array. Every array is a copy, taken when this returns."""
    return {"params": _nest(train_state.params, root),
            "state": _nest(train_state.state, root),
            "opt_state": export_jax_opt_state(train_state.opt_state, root),
            "step": np.asarray(train_state.step, np.int32)}


@torch.no_grad()
def load_checkpoint_tree(train_state, model: torch.nn.Module,
                         tree: Mapping[str, Any]):
    """The inverse of :func:`checkpoint_tree`: load a JAX-form training
    tree (a loaded checkpoint of either framework) into ``model``'s
    parameters and buffers (:func:`load_jax_params`) and
    ``train_state``'s optimizer state and step
    (:func:`load_jax_opt_state`), in place. Raises where names, shapes or
    structures differ. Returns ``train_state``."""
    load_jax_params(model, {"params": tree["params"],
                            "state": tree.get("state") or {}})
    return load_jax_opt_state(train_state, tree["opt_state"], tree["step"])
