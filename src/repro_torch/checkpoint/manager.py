"""Checkpointing: atomic, keep-k, one directory layout with the reference.

Port of `repro.checkpoint.manager.CheckpointManager`. A checkpoint is
``step_XXXXXXXX/`` holding one ``.npy`` per leaf and ``manifest.json``
({"step", "arrays": {name: {"file", "shape", "dtype"}}, "extra"}); leaf
names are the reference's `_path_str` of the saved tree
(`interop.tree_named_leaves`: for the trainer's ``(params, opt_state)``,
``0/layers/attn/wq``, ``1/step``, ``1/mu/embed``), and a file is the name
with ``/`` → ``__``. Writes go to
``step_XXXXXXXX.tmp/`` and are published by one rename; keep_k old steps
are removed after the new one is durable.

bfloat16: numpy has no bf16 type without ``ml_dtypes``, which the card's
host lacks, so a bf16 leaf is stored as its uint16 bit pattern, with
``"dtype": "bfloat16"`` in the manifest; restore reads those bits back
(also from a ``.npy`` that holds them as 2-byte void records). Every other
leaf is stored as numpy stores its type, so a float32 checkpoint written by
the reference restores here leaf for leaf, and the reverse.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..interop import tree_named_leaves, tree_unflatten


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_k: int = 3

    def __post_init__(self):
        self.dir = pathlib.Path(self.directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None
             ) -> pathlib.Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        manifest: Dict[str, Any] = {"step": step, "arrays": {},
                                    "extra": extra or {}}
        for name, leaf in tree_named_leaves(tree):
            arr, dtype_name = _to_numpy(leaf)
            fname = name.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest["arrays"][name] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype_name}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._gc()
        return final

    # -- restore ------------------------------------------------------------

    def steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device: Optional[DeviceLike] = None) -> Any:
        """Restore into the structure of ``tree_like``: each leaf takes its
        template's type, and lands on ``device`` (default: the template
        leaf's device)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        src = self.dir / f"step_{step:08d}"
        manifest = json.loads((src / "manifest.json").read_text())
        dev = resolve_device(device) if device is not None else None
        out = []
        for name, leaf in tree_named_leaves(tree_like):
            meta = manifest["arrays"][name]
            t = _to_tensor(np.load(src / meta["file"]), meta["dtype"])
            if tuple(t.shape) != tuple(meta["shape"]):
                raise ValueError(f"{name}: file holds {tuple(t.shape)}, "
                                 f"manifest says {tuple(meta['shape'])}")
            if isinstance(leaf, torch.Tensor):
                t = t.to(dev or leaf.device, leaf.dtype)
            elif dev is not None:
                t = t.to(dev)
            out.append(t)
        return tree_unflatten(tree_like, out)

    def extra(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        src = self.dir / f"step_{step:08d}"
        return json.loads((src / "manifest.json").read_text())["extra"]

    # -- gc -----------------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep_k]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
