"""Parameter trees between the JAX reference (as numpy) and the port.

The two frameworks cannot share random number streams, so weights are drawn
once (by `repro`'s ``eq.init``, or with numpy), handed over as numpy arrays,
and carried across here. A tree is any nesting of dicts, lists and tuples;
the leaves that are arrays (numpy arrays, numpy scalars, tensors) convert,
every other leaf (python numbers, strings, None) passes through unchanged.
This covers ``eq.init`` params, BN state, ``params["qat"]``, folded
``((w, b), …)`` tuples, FIR and Volterra params and optimizer states (a
NamedTuple such as ``AdamState`` keeps its class: `adam_state_to_torch`
rebuilds the port's from the reference's, and the reference's
``AdamState(*to_numpy(state))`` takes the port's back). `tree_map`,
`tree_leaves`, `tree_named_leaves` and `tree_unflatten` are the port's tree
utilities (the optimizer, the training loops and the checkpoints use them
too).

bfloat16 numpy arrays (the ``ml_dtypes`` dtype) become bf16 tensors; a bf16
tensor comes back as float32 numpy, which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure. Dicts, lists,
    tuples and NamedTuples are nodes (a NamedTuple such as ``AdamState``
    keeps its type); None is an empty subtree; anything else is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the reference's order (dict keys sorted, as jax.tree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_named_leaves(tree: Any, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, Any]]:
    """(name, leaf) in `tree_leaves` order, named as the reference's
    `repro.parallel.sharding._path_str` names a path: dict keys, NamedTuple
    field names and sequence indices joined with "/" (for the trainer's
    ``(params, opt_state)``: ``0/layers/attn/wq``, ``1/step``,
    ``1/mu/embed``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [nl for k in sorted(tree)
                for nl in tree_named_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or [str(i) for i in
                                                   range(len(tree))]
        return [nl for name, v in zip(names, tree)
                for nl in tree_named_leaves(v, prefix + (name,))]
    return [("/".join(prefix), tree)]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``template`` with ``leaves`` in `tree_leaves`
    order (dict keys sorted)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [build(v) for v in node]
            if hasattr(node, "_fields"):
                return type(node)(*items)
            return type(node)(items)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _array_to_tensor(a: Any, dev: torch.device) -> Any:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    if not isinstance(a, (np.ndarray, np.generic)) and not hasattr(
            a, "__array__"):
        return a                                   # python scalar, str, None
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def _tensor_to_array(t: Any) -> Any:
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def to_torch(tree: Any, device: DeviceLike = "cuda") -> Any:
    """numpy (or array-like) leaves → tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _array_to_tensor(a, dev), tree)


def to_numpy(tree: Any) -> Any:
    """Tensor leaves → numpy arrays on the host (bf16 → float32)."""
    return tree_map(_tensor_to_array, tree)


def adam_state_to_torch(state: Any, device: DeviceLike = "cuda") -> Any:
    """The reference's ``AdamState(step, mu, nu)`` (arrays or numpy) → the
    port's `optim.adam.AdamState` on ``device``."""
    from .optim.adam import AdamState
    step, mu, nu = state
    return AdamState(*to_torch((step, mu, nu), device))
